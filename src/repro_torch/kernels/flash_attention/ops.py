"""Wrapper of the flash-attention kernel: q (B, Hq, S, D), k and v
(B, Hkv, S, D) in, (B, Hq, S, D) out.

Routes by backend and device: ``backend="reference"`` or a CPU tensor runs
the plain version (``chunked.chunked_attention``); a CUDA tensor with the
default ``backend="cuda"`` launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises — on a dtype other than bf16, a
head dim outside ``SUPPORTED_D``, a build or a launch error. Nothing falls
back quietly. Forward only: a call that would need a gradient raises.

``launches`` counts kernel launches and nothing else adds to it;
``shapes`` counts ``(B, Hq, Hkv, S, D, window)`` of each nonempty call on
either device, so a run can show which shapes its path gave the kernel.
Unlike the TPU wrapper, S need not be a multiple of a block: the kernel
masks keys and rows past S itself.

The kernel reads q, k and v by TMA through their strides (only the last
dim must be contiguous; ``_aligned`` copies what TMA cannot read in
place), and writes its output in (B, S, Hq, D) memory order returned as
a (B, Hq, S, D) view, so the transformer's head merge after it is a free
reshape.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.chunked import chunked_attention

BACKENDS = ("cuda", "reference")
SUPPORTED_D = (96, 128, 256)

launches = 0
shapes: Counter = Counter()
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel's TMA loads can read it in place (a
    contiguous last dim; the other strides positive multiples of 8
    elements, 16 bytes, on every axis longer than 1; a 16-byte aligned
    base), else a contiguous copy."""
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
            s % 8 == 0 and (s > 0 or n == 1)
            for s, n in zip(x.stride()[:-1], x.shape[:-1])):
        return x
    return x.contiguous()


def _launch(q, k, v, causal, window, softcap) -> torch.Tensor:
    global launches
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: the kernel takes bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in SUPPORTED_D:
        raise ValueError(f"flash_attention: head dim {D} not supported by "
                         f"the kernel (supported: {SUPPORTED_D})")
    if B * Hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {B * Hq} exceeds the "
                         f"grid's 65535")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, S, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B == 0 or S == 0 or Hq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(
        s for x in (q, k, v, out) for s in x.stride()[:3]))
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(lib, fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, S, D, strides, int(causal),
            0 if window is None else int(window),
            0.0 if softcap is None else float(softcap), 1.0 / D ** 0.5,
            stream), "flash_attention_fwd")
    launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    softcap: float | None = None,
                    backend: str = "cuda") -> torch.Tensor:
    """Softmax attention forward with GQA (q head h reads kv head
    h // (Hq / Hkv)), an optional causal mask, sliding window (keys in
    [i - window + 1, i]) and tanh logit softcap."""
    if backend not in BACKENDS:
        raise ValueError(f"flash_attention: unknown backend {backend!r} "
                         f"(one of {BACKENDS})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in the port; its backward "
            "(an autograd.Function over the chunked recompute) comes with "
            "training, ROADMAP Queue 1 item 15")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[::3] != k.shape[::3] or q.shape[2] != k.shape[2] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention: need q (B, Hq, S, D) and k, v "
                         f"(B, Hkv, S, D) with Hq % Hkv == 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    if backend == "reference":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    B, Hq, S, D = q.shape
    if q.numel():
        shapes[(B, Hq, k.shape[1], S, D, window)] += 1
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, window, softcap)
