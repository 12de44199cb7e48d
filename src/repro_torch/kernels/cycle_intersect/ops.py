"""Wrapper of the cycle_intersect kernel: ci (R, W), cj (R, Wj) int32 →
(R, W) int32 positions of the last match in each ``cj`` row, or -1.

Routes by the tensors' device: CUDA tensors launch the hand-written kernel
(``csrc/cycle_intersect.cu``) or raise; CPU tensors run the plain version
(``ref.intersect_rows_ref``). Nothing falls back quietly. ``launches``
counts kernel launches and ``shapes`` the (R, W, Wj) of each nonempty call
on either device, so a run can show which shapes its path gave the
kernel. No host padding:
the kernel takes any R, W and Wj. ``work`` gives one launch's ops and
bytes from its shape.
"""
from __future__ import annotations

import math

from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref

launches = 0
shapes: Counter = Counter()
_launch = _build.Launcher("cycle_intersect", "cycle_intersect_launch")


def intersect_rows(ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``intersect_rows_ref``. Row-interior sentinels
    (ci == cj == N) still match, as in the reference; callers mask them by
    window validity."""
    global launches
    index = ci.get_device()                 # -1: not a CUDA tensor
    if index < 0:
        dev = ci.device
        if dev != cj.device:
            raise ValueError(f"intersect_rows: ci on {dev}, cj on "
                             f"{cj.device}")
        if dev.type != "cpu":
            raise ValueError(f"intersect_rows: unsupported device {dev}")
        if ci.numel() and cj.numel():
            shapes[(ci.shape[0], ci.shape[1], cj.shape[1])] += 1
        return intersect_rows_ref(ci, cj)
    # the CUDA route: every check is a cheap attribute read, since at the
    # solver's shapes the host time of this call is its cost
    if cj.get_device() != index:
        raise ValueError(f"intersect_rows: ci on {ci.device}, cj on "
                         f"{cj.device}")
    try:
        R, W = ci.shape
        R2, Wj = cj.shape
    except ValueError:
        R2 = None
    if R2 is None or R2 != R:
        raise ValueError(f"intersect_rows: need (R, W) and (R, Wj), got "
                         f"{tuple(ci.shape)} and {tuple(cj.shape)}")
    if R == 0 or W == 0 or Wj == 0:
        return torch.full((R, W), -1, dtype=torch.int32, device=ci.device)
    if ci.dtype is not torch.int32 or not ci.is_contiguous():
        ci = ci.to(torch.int32).contiguous()
    if cj.dtype is not torch.int32 or not cj.is_contiguous():
        cj = cj.to(torch.int32).contiguous()
    out = torch.empty_like(ci)
    _launch(index, ci.data_ptr(), cj.data_ptr(), out.data_ptr(), R, W, Wj)
    launches += 1
    shapes[(R, W, Wj)] += 1
    return out


def work(R: int, W: int, Wj: int) -> tuple[int, int]:
    """(integer ops, bytes) of one launch on (R, W) × (R, Wj) int32: both
    inputs read and the (R, W) output written once; one upper-bound search
    of ceil(log2(Wj + 1)) compares per element, 2 ops each (compare and
    select)."""
    return 2 * R * W * math.ceil(math.log2(Wj + 1)), 4 * (2 * R * W + R * Wj)
