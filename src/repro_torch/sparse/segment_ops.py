"""Segment reductions (port of the part of ``repro.sparse.segment_ops`` the
solver's main path uses).

Out-of-range segment ids are dropped, as ``jax.ops.segment_*`` drops them:
they are routed to one extra dead segment that is sliced off.

Float sums take a FIXED order, the same on every device. ``index_add_``/
``scatter_add_`` on CUDA use atomics, whose order changes from run to run,
and ``torch.segment_reduce`` on CUDA sums a segment in another order than on
the CPU; a one-ulp wobble in a reparametrised cost can flip a contraction
decision. So :func:`segment_sum` stable-sorts the entries by segment and
adds each segment's entries one by one in input order, starting from 0.0
(:func:`sequential_sums`) — the reference's sequential scatter-add order
exactly, on the CPU and on the card alike. Integer min/max scatters are
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


def sequential_sums(data: torch.Tensor, starts: torch.Tensor,
                    lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Sum of ``data[starts[s]:starts[s] + lengths[s]]`` for each segment
    s, added one entry at a time in order from 0.0: step j adds every
    segment's j-th entry, so each sum takes the same order on any device.
    Finished segments add +0.0, which leaves a sum that starts from +0.0
    unchanged. ``max_len`` >= every length (a host int)."""
    acc = torch.zeros(starts.shape, dtype=data.dtype, device=data.device)
    if data.numel() == 0:
        return acc
    last = data.shape[0] - 1
    zero = torch.zeros_like(acc)
    for j in range(max_len):
        acc = acc + torch.where(lengths > j,
                                data[(starts + j).clamp(max=last)], zero)
    return acc


class SegmentPlan(NamedTuple):
    """A fixed-order reduction plan for one segment-id array: the stable
    permutation grouping entries by segment (input order kept inside a
    segment), each segment's start and length in that order, and the
    longest segment. Reused when the same ids are summed many times (every
    message-passing iteration)."""
    perm: torch.Tensor      # (n,) stable sort of the routed ids
    starts: torch.Tensor    # (num_segments,) first entry in sorted order
    lengths: torch.Tensor   # (num_segments,) dropped ids not counted
    max_len: int            # longest segment (read once, on the host)

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        return sequential_sums(values.reshape(-1)[self.perm], self.starts,
                               self.lengths, self.max_len)


def segment_plan(segment_ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The plan of ``segment_ids``; out-of-range ids are dropped (they sort
    after every segment). Costs one host sync, for the longest segment."""
    ids = _route(segment_ids.reshape(-1), num_segments)
    perm = torch.sort(ids, stable=True).indices
    lengths = torch.zeros(num_segments + 1, dtype=torch.int64,
                          device=ids.device)
    lengths.scatter_add_(0, ids, torch.ones_like(ids))
    lengths = lengths[:num_segments]
    starts = torch.cumsum(lengths, 0) - lengths
    max_len = int(lengths.max()) if num_segments else 0
    return SegmentPlan(perm=perm, starts=starts, lengths=lengths,
                       max_len=max_len)


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
