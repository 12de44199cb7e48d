"""Wrapper of the triangle_mp kernel: (T, 3) float32 in, (T, 3) out.

Routes by the tensor's device: a CUDA tensor launches the hand-written
kernel (``csrc/triangle_mp.cu``) or raises; a CPU tensor runs the plain
version (``ref.mp_sweep_ref``). Nothing falls back quietly. ``launches``
counts kernel launches, and nothing else adds to it; ``shapes`` counts the T
of each call on either device, so a run can show which shapes its path gave
the kernel. Unlike the TPU wrapper there is no padding: the kernel masks its
own ragged tail.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.triangle_mp.ref import mp_sweep_ref

launches = 0
shapes: Counter = Counter()     # T of each nonempty call
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("triangle_mp")
        fn = lib.triangle_mp_sweep
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def mp_sweep(t_cost: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``mp_sweep_reference``: (T, 3) float32 → (T, 3)."""
    global launches
    if t_cost.device.type == "cpu":
        if t_cost.shape[0]:
            shapes[t_cost.shape[0]] += 1
        return mp_sweep_ref(t_cost)
    if t_cost.device.type != "cuda":
        raise ValueError(f"mp_sweep: unsupported device {t_cost.device}")
    if t_cost.dtype != torch.float32 or t_cost.dim() != 2 \
            or t_cost.shape[1] != 3:
        raise ValueError(f"mp_sweep: need (T, 3) float32, got "
                         f"{tuple(t_cost.shape)} {t_cost.dtype}")
    x = t_cost.contiguous()
    out = torch.empty_like(x)
    T = x.shape[0]
    if T == 0:
        return out
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(lib, fn(x.data_ptr(), out.data_ptr(), T, stream),
                     "triangle_mp_sweep")
    launches += 1
    shapes[T] += 1
    return out
