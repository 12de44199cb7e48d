"""Segment reductions (port of the part of ``repro.sparse.segment_ops`` the
solver's main path uses).

Out-of-range segment ids are dropped, as ``jax.ops.segment_*`` drops them:
they are routed to one extra dead segment that is sliced off.

Float sums take a FIXED order. ``index_add_``/``scatter_add_`` on CUDA use
atomics, whose order changes from run to run; a one-ulp wobble in a
reparametrised cost can flip a contraction decision. So :func:`segment_sum`
stable-sorts the entries by segment and reduces each segment in input order
with ``torch.segment_reduce`` — on the CPU that is the reference's
sequential scatter-add order exactly. Integer min/max scatters are
order-free and use ``scatter_reduce_``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


def _route(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ids = segment_ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, torch.full_like(ids, num_segments))


class SegmentPlan(NamedTuple):
    """A fixed-order reduction plan for one segment-id array: the stable
    permutation grouping entries by segment (input order kept inside a
    segment) and the per-segment lengths. Reused when the same ids are
    summed many times (every message-passing iteration)."""
    perm: torch.Tensor      # (n,) stable sort of the routed ids
    lengths: torch.Tensor   # (num_segments + 1,) last = dropped ids

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        data = values.reshape(-1)[self.perm]
        out = torch.segment_reduce(data, "sum", lengths=self.lengths,
                                   unsafe=True)
        return out[:-1]


def segment_plan(segment_ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    ids = _route(segment_ids.reshape(-1), num_segments)
    perm = torch.sort(ids, stable=True).indices
    lengths = torch.zeros(num_segments + 1, dtype=torch.int64,
                          device=ids.device)
    lengths.scatter_add_(0, ids, torch.ones_like(ids))
    return SegmentPlan(perm=perm, lengths=lengths)


def segment_sum(values, segment_ids, num_segments: int):
    """Fixed-order segment sum (see module note). Empty segments are 0."""
    if not values.dtype.is_floating_point:
        ids = _route(segment_ids, num_segments)
        out = torch.zeros(num_segments + 1, dtype=values.dtype,
                          device=values.device)
        return out.scatter_add_(0, ids, values)[:num_segments]
    return segment_plan(segment_ids, num_segments).sum(values)


def _identity(dtype, largest: bool):
    if dtype.is_floating_point:
        return float("-inf") if largest else float("inf")
    info = torch.iinfo(dtype)
    return info.min if largest else info.max


def _segment_extreme(values, segment_ids, num_segments: int, reduce: str):
    ids = _route(segment_ids, num_segments)
    out = torch.full((num_segments + 1,),
                     _identity(values.dtype, reduce == "amax"),
                     dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, ids, values, reduce, include_self=True)
    return out[:num_segments]


def segment_max(values, segment_ids, num_segments: int):
    """Per-segment max; empty segments hold the dtype's lowest value
    (-inf for floats), as ``jax.ops.segment_max`` does."""
    return _segment_extreme(values, segment_ids, num_segments, "amax")


def segment_min(values, segment_ids, num_segments: int):
    """Per-segment min; empty segments hold the dtype's largest value."""
    return _segment_extreme(values, segment_ids, num_segments, "amin")


def segment_argmax(values, segment_ids, num_segments: int, mask=None):
    """Index (into ``values``) of the max element of each segment, ties
    broken toward the smallest index. Returns (argmax_idx, max_val); empty
    segments get idx = -1, val = -inf."""
    if mask is not None:
        values = torch.where(mask, values,
                             torch.full_like(values, NEG_INF))
    seg_max = segment_max(values, segment_ids, num_segments)
    n = values.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=values.device)
    is_max = values >= seg_max[segment_ids.long()]
    cand = torch.where(is_max, idx, torch.full_like(idx, n))
    arg = segment_min(cand, segment_ids, num_segments)
    arg = torch.where(arg >= n, torch.full_like(arg, -1), arg)
    return arg.to(torch.int32), seg_max
