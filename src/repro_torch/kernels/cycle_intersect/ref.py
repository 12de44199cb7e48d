"""Plain PyTorch version of sorted-row intersection: per-row binary search.

Contract (the reference's): ``ci`` (R, W) and ``cj`` (R, Wj) int32, each
``cj`` row sorted ascending (padding = a sentinel that sorts last; ``ci``
need not be sorted). ``pos[r, p]`` is the index into row r of ``cj`` of the
LAST element equal to ``ci[r, p]``, or -1 when absent. Sentinel padding in
``ci`` matches sentinel padding in ``cj`` — callers mask by window validity.
"""
from __future__ import annotations

import torch


def intersect_rows_ref(ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    """(R, W) × (R, Wj) → (R, W) int32 match positions (−1 = no match)."""
    R, W = ci.shape
    Wj = cj.shape[1]
    if Wj == 0 or R == 0 or W == 0:
        return torch.full((R, W), -1, dtype=torch.int32, device=ci.device)
    ci = ci.to(torch.int32).contiguous()
    cj = cj.to(torch.int32).contiguous()
    pos = torch.searchsorted(cj, ci, right=True) - 1
    pc = pos.clamp(0, Wj - 1)
    hit = torch.gather(cj, 1, pc) == ci
    return torch.where((pos >= 0) & hit, pos,
                       torch.full_like(pos, -1)).to(torch.int32)
