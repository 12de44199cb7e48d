"""Segment reductions and COO utilities (port of ``repro.sparse.segment_ops``).

Out-of-range segment ids are dropped, as ``jax.ops.segment_*`` drops them:
they are routed to one extra dead segment that is sliced off.

Two float sums, for two kinds of caller:

- :func:`segment_sum` adds in a FIXED order, the same on every device.
  ``index_add_``/``scatter_add_`` on CUDA use atomics, whose order changes
  from run to run, and ``torch.segment_reduce`` on CUDA sums a segment in
  another order than on the CPU; a one-ulp wobble in a reparametrised cost
  can flip a contraction decision. So it stable-sorts the entries by
  segment and adds each segment's entries one by one in input order,
  starting from 0.0 (:func:`sequential_sums`) — the reference's sequential
  scatter-add order exactly, on the CPU and on the card alike. The
  multicut solver and :func:`coo_dedupe_sum` use it.
- :func:`scatter_sum` is one ``index_add`` (atomics on CUDA, order not
  fixed), for sums that feed no discrete decision: GNN message
  aggregation, bags of embeddings, :func:`segment_mean` and
  :func:`segment_softmax`. They are held against the reference within a
  tolerance. ``sequential_sums`` runs one step per entry of the longest
  segment and keeps every step for autograd: far too slow and too large
  for a GNN's backward.

Integer min/max scatters are order-free and use ``scatter_reduce_``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.graph import lexsort

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
    out = torch.full((num_segments + 1,) + tuple(values.shape[1:]),
                     _identity(values.dtype, reduce == "amax"),
                     dtype=values.dtype, device=values.device)
    if values.dim() > 1:        # (n, ...) values, one id per row
        ids = ids.reshape(ids.shape + (1,) * (values.dim() - 1)) \
            .expand_as(values)
    out.scatter_reduce_(0, ids, values, reduce, include_self=True)
    return out[:num_segments]


def segment_max(values, segment_ids, num_segments: int):
    """Per-segment max of ``values`` (n,) or (n, ...) rows; empty segments
    hold the dtype's lowest value (-inf for floats), as
    ``jax.ops.segment_max`` does."""
    return _segment_extreme(values, segment_ids, num_segments, "amax")


def segment_min(values, segment_ids, num_segments: int):
    """Per-segment min; empty segments hold the dtype's largest value
    (+inf for floats)."""
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


def scatter_sum(values, segment_ids, num_segments: int):
    """Segment sum of ``values`` (n,) or (n, ...) rows by one
    ``index_add`` (order not fixed on CUDA; see the module note).
    Differentiable; empty segments are 0."""
    ids = _route(segment_ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add(0, ids, values)[:num_segments]


def segment_mean(values, segment_ids, num_segments: int):
    """Per-segment mean; empty segments are 0."""
    ones = torch.ones(values.shape[:1], dtype=values.dtype,
                      device=values.device)
    tot = scatter_sum(values, segment_ids, num_segments)
    cnt = scatter_sum(ones, segment_ids, num_segments)
    return tot / torch.clamp(cnt, min=1).reshape(
        cnt.shape + (1,) * (tot.dim() - cnt.dim()))


def segment_softmax(logits, segment_ids, num_segments: int, mask=None):
    """Numerically-stable softmax within each segment (e.g. GAT edge
    scores); masked entries get 0."""
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    ids = segment_ids.long()
    expd = torch.exp(logits - seg_max[ids])
    if mask is not None:
        expd = torch.where(mask, expd, torch.zeros_like(expd))
    denom = scatter_sum(expd, segment_ids, num_segments)
    return expd / torch.clamp(denom[ids], min=1e-30)


def canonical_edge_key(u, v, num_nodes: int):
    """Order-independent dense key for an undirected edge, in ``u``'s
    dtype. Only safe when ``num_nodes**2`` fits that dtype; large-N paths
    use :func:`coo_dedupe_sum`'s lexicographic sort instead."""
    return torch.minimum(u, v) * num_nodes + torch.maximum(u, v)


def coo_dedupe_sum(u, v, w, valid, num_nodes: int):
    """Merge parallel edges of a padded COO list, summing weights.

    The Thrust ``sort_by_key`` + ``reduce_by_key`` of RAMA Alg. 4 with
    static shapes: a stable lexicographic sort by canonical (lo, hi)
    endpoint pairs, a prefix sum of "is-new-key" flags giving each unique
    edge a dense slot, a fixed-order sum of the weights by slot.

    Returns (u', v', w', valid', n_unique) with the same padded length;
    slots beyond n_unique are invalid (u=v=0, w=0). Self loops (u==v) and
    invalid entries are dropped. The integers equal the reference's.
    """
    E = u.shape[0]
    dev = u.device
    drop = ~valid | (u == v)
    sentinel = torch.full((E,), num_nodes, dtype=torch.int32, device=dev)
    # dead rows get sentinel endpoints that sort after every live row
    lo = torch.where(drop, sentinel, torch.minimum(u, v).to(torch.int32))
    hi = torch.where(drop, sentinel, torch.maximum(u, v).to(torch.int32))
    order = lexsort((hi, lo))
    lo_s, hi_s = lo[order], hi[order]
    w_s = torch.where(drop, torch.zeros_like(w), w)[order]
    live = lo_s < num_nodes
    is_new = torch.ones(E, dtype=torch.int32, device=dev)
    is_new[1:] = ((lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])).to(
        torch.int32)
    is_new = torch.where(live, is_new, torch.zeros_like(is_new))
    slot = torch.cumsum(is_new, 0, dtype=torch.int32) - 1
    n_unique = is_new.sum(dtype=torch.int32)
    slot = torch.where(live, slot, torch.full_like(slot, E - 1))

    w_acc = segment_sum(w_s, slot, E)
    # the first row of each slot carries the endpoints
    idx = torch.arange(E, dtype=torch.int32, device=dev)
    first = torch.where(is_new == 1, idx, torch.full_like(idx, E))
    first_of_slot = torch.clamp(segment_min(first, slot, E), 0, E - 1).long()
    valid_out = idx < n_unique
    zero = torch.zeros_like(lo_s)
    u_out = torch.where(valid_out, lo_s[first_of_slot], zero)
    v_out = torch.where(valid_out, hi_s[first_of_slot], zero)
    w_out = torch.where(valid_out, w_acc, torch.zeros_like(w_acc))
    return u_out, v_out, w_out, valid_out, n_unique
