"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by one ``nvcc`` into its own shared library with a
plain C entry point, and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds, not the minutes ``torch.utils.cpp_extension`` needs.
All missing libraries are compiled in parallel (one ``nvcc`` per source,
started together). Libraries go under ``build/repro_torch/`` at the repo
root (``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the
source and flags, so a changed source rebuilds and an unchanged one is
reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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
