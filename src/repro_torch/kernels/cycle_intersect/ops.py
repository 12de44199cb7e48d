"""Wrapper of the cycle_intersect kernel: ci (R, W), cj (R, Wj) int32 →
(R, W) int32 positions of the last match in each ``cj`` row, or -1.

Routes by the tensors' device: CUDA tensors launch the hand-written kernel
(``csrc/cycle_intersect.cu``) or raise; CPU tensors run the plain version
(``ref.intersect_rows_ref``). Nothing falls back quietly. ``launches``
counts kernel launches and ``shapes`` the (R, W, Wj) of each nonempty call
on either device, so a run can show which shapes its path gave the
kernel. No host padding:
the kernel takes any R, W and Wj.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref

launches = 0
shapes: Counter = Counter()
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("cycle_intersect")
        fn = lib.cycle_intersect_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def intersect_rows(ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``intersect_rows_ref``. Row-interior sentinels
    (ci == cj == N) still match, as in the reference; callers mask them by
    window validity."""
    global launches
    if ci.device != cj.device:
        raise ValueError(f"intersect_rows: ci on {ci.device}, cj on "
                         f"{cj.device}")
    if ci.device.type == "cpu":
        if ci.numel() and cj.numel():
            shapes[(ci.shape[0], ci.shape[1], cj.shape[1])] += 1
        return intersect_rows_ref(ci, cj)
    if ci.device.type != "cuda":
        raise ValueError(f"intersect_rows: unsupported device {ci.device}")
    if ci.dim() != 2 or cj.dim() != 2 or ci.shape[0] != cj.shape[0]:
        raise ValueError(f"intersect_rows: need (R, W) and (R, Wj), got "
                         f"{tuple(ci.shape)} and {tuple(cj.shape)}")
    R, W = ci.shape
    Wj = cj.shape[1]
    if R == 0 or W == 0 or Wj == 0:
        return torch.full((R, W), -1, dtype=torch.int32, device=ci.device)
    a = ci.to(torch.int32).contiguous()
    b = cj.to(torch.int32).contiguous()
    out = torch.empty((R, W), dtype=torch.int32, device=ci.device)
    lib, fn = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _build.check(lib, fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             R, W, Wj, stream), "cycle_intersect_rows")
    launches += 1
    shapes[(R, W, Wj)] += 1
    return out
