"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by one ``nvcc`` into its own shared library with a
plain C entry point, and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds, not the minutes ``torch.utils.cpp_extension`` needs.
All missing libraries are compiled in parallel (one ``nvcc`` per source,
started together). Libraries go under ``build/repro_torch/`` at the repo
root (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the
source and flags, so a changed source rebuilds and an unchanged one is
reused. Nothing here runs at import time.

``Launcher`` is the host path of a launch: a C entry point bound once
(library loaded and ``argtypes`` set at its first call), then per call the
raw handle of PyTorch's current stream on the tensors' device and one
ctypes call with two arguments, the address of the call's integer
arguments packed as 64-bit words and the stream (ctypes converts each
argument it is given, so fewer arguments cost less host time); the entry
point makes the device current only when it is not, so no
``torch.cuda.device`` context is entered.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# per-kernel flags: the sweep must not contract γ·m into an FMA, or it
# stops being bitwise equal to its plain version (separate torch ops)
KERNELS = {
    "triangle_mp": ["-fmad=false"],
    "cycle_intersect": [],
    "flash_attention": [],
    "contract_matmul": [],
}

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # name -> nvcc's -Xptxas -v report


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are compiled at first use")


def _flags(name: str) -> list[str]:
    return ARCH + BASE_FLAGS + KERNELS[name]


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return build_dir() / f"lib{name}-{h[:16]}.so"


def build_all(names=None) -> float:
    """Compile every kernel library that is not built yet, all ``nvcc``
    processes at once. Returns the wall seconds spent. Raises on a failed
    compile with the compiler's output."""
    names = list(KERNELS) if names is None else list(names)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc()] + _flags(name) + ["-o", str(tmp),
                                         str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        build_log[name] = log
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exit {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def ptxas_report(name: str) -> list[dict]:
    """Per kernel function of library ``name``, what ``-Xptxas -v`` said
    when this process built it: registers, stack and spill bytes, and the
    codes of ptxas's performance notes (C7514/C7518: wgmma serialized,
    C7517: a wait injected; C7508: setmaxnreg ignored). Empty when the
    library was not built in this process."""
    rows, notes, cur = [], {}, None
    for ln in build_log.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = dict(function=_short_name(m.group(1)))
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
        m = re.search(r"\((C7\d\d\d)\).*function '([^'\s]+)", ln)
        if m:
            notes.setdefault(_short_name(m.group(2)), []).append(m.group(1))
    for r in rows:
        r["notes"] = sorted(set(notes.get(r["function"], [])))
    return rows


def _short_name(mangled: str) -> str:
    """``flash_fwd_kernel<256, 1>`` from its mangled name."""
    m = re.search(r"\d([a-z_]+kernel)(.*)", mangled)
    if m is None:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2).split("Ev", 1)[0])
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a kernel's C entry point reports a CUDA error (the launch
    was refused, or an earlier asynchronous fault surfaced)."""
    if rc != 0:
        fn = lib.repro_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({fn(rc).decode(errors='replace')})")


class Launcher:
    """C entry point ``int symbol(const long long* words, void* stream)``
    of library ``name``: ``words[0]`` is the CUDA device index, the rest
    the call's integer arguments (pointers as addresses) in order.
    ``launcher(device_index, *args)`` launches on PyTorch's current stream
    of that device and raises on a CUDA error. The library is loaded, the
    ``argtypes`` set and the stream lookup fetched at the first call; each
    thread packs into its own words."""

    WORDS = 32

    def __init__(self, name: str, symbol: str):
        self.name, self.symbol = name, symbol
        self._lib = self._fn = self._stream = None
        self._local = threading.local()

    def _bind(self):
        lib = load(self.name)
        fn = getattr(lib, self.symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self._lib, self._fn = lib, fn
        # the raw cudaStream_t of PyTorch's current stream on a device, as
        # Triton's launcher reads it; CUDA builds of torch only
        self._stream = torch._C._cuda_getCurrentRawStream
        return fn

    def __call__(self, index: int, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self._bind()
        local = self._local
        try:
            words, addr = local.words, local.addr
        except AttributeError:
            words = local.words = (ctypes.c_longlong * self.WORDS)()
            addr = local.addr = ctypes.addressof(words)
        words[0] = index
        words[1:len(args) + 1] = args
        rc = fn(addr, self._stream(index))
        if rc:
            check(self._lib, rc, self.symbol)
