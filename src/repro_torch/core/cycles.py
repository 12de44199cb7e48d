"""Dual: conflicted-cycle separation (RAMA §3.2.2, Alg. 5).

Port of ``repro.core.cycles``. A conflicted cycle holds exactly one
repulsive edge. Two data paths enumerate them, and give identical
triangles and chords whenever the row cap covers the attractive degrees:

* **dense** — (N, N) boolean adjacency and edge-index matrices: common
  neighbours are a row AND, 2-path existence a row-dot ``A⁺A⁺``;
* **sparse** — sorted-row intersection of CSR row windows (the
  ``cycle_intersect`` kernel through the ``intersect=`` hook), O(N + E).

4/5-cycles are triangulated with zero-cost chord edges allocated from the
instance's free padded slots (shared by both paths). The reference's
``vmap``s become batch dimensions written out and its ``lax.scan`` chunk
streams become Python loops. Sparse separation splits into a candidate
phase (per-repulsive-edge, read-only) and an allocate/assemble phase in
canonical (repulsive-edge, chord-kind) order, so results do not depend on
``separation_chunk``. ``separation_shards`` = S > 1 splits the candidate
phase's batch into S contiguous shards, shard r on the r-th device of
:func:`repro_torch.core.dist.shard_devices` (the reference's
``shard_map`` over ``separation_mesh(S)``, single-controller here too:
one process, one shard after another from the host); the winners are
gathered back on the instance's device, where chords are allocated once,
so results do not depend on S either.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core import dist as _dist
from repro_torch.core.contraction import adjacency_dense
from repro_torch.core.graph import (
    CsrGraph, DEFAULT_SPARSE_THRESHOLD, MulticutInstance, csr_filter,
    csr_from_instance, csr_lookup_edge, csr_row_window, lexsort,
    resolve_graph_impl, splice_csr,
)
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref
from repro_torch.sparse.segment_ops import segment_max, segment_min
from repro_torch.tree import tree_map


class DenseAdj(NamedTuple):
    """The (N, N) boolean/index pair dense separation reads."""
    Apos: torch.Tensor   # (N, N) bool attractive adjacency
    eidx: torch.Tensor   # (N, N) int32 edge index or -1


class DenseGraph(NamedTuple):
    A: torch.Tensor      # (N, N) symmetric f32 costs
    Apos: torch.Tensor   # (N, N) bool attractive adjacency
    eidx: torch.Tensor   # (N, N) int32 edge index or -1


def build_adjacency(inst: MulticutInstance) -> DenseAdj:
    """Boolean adjacency + edge-index matrices (what separation reads).

    The reference's scatter-max ``Apos.at[su, sv].max(pos)`` is an OR, so
    here every attractive edge fills True and every other edge fills a
    discarded slot: deterministic without atomics. ``eidx`` is an int32
    ``scatter_reduce_("amax")`` over flat indices, order-free. Invalid
    edges point at (0, 0), which is reset to -1 afterwards, as in the
    reference."""
    N = inst.num_nodes
    dev = inst.u.device
    ev = inst.edge_valid
    pos = ev & (inst.cost > 0)
    su = torch.where(ev, inst.u, torch.zeros_like(inst.u)).long()
    sv = torch.where(ev, inst.v, torch.zeros_like(inst.v)).long()
    drop = torch.full_like(su, N * N)
    flat = torch.cat([torch.where(pos, su * N + sv, drop),
                      torch.where(pos, sv * N + su, drop)])
    Apos = torch.zeros(N * N + 1, dtype=torch.bool, device=dev)
    Apos.index_fill_(0, flat, True)
    eid = torch.where(ev, torch.arange(inst.num_edges, dtype=torch.int32,
                                       device=dev),
                      torch.full_like(inst.u, -1)).to(torch.int32)
    eidx = torch.full((N * N,), -1, dtype=torch.int32, device=dev)
    eidx.scatter_reduce_(0, torch.cat([su * N + sv, sv * N + su]),
                         torch.cat([eid, eid]), "amax", include_self=True)
    eidx[:1].fill_(-1)
    return DenseAdj(Apos=Apos[:N * N].view(N, N), eidx=eidx.view(N, N))


def build_dense(inst: MulticutInstance) -> DenseGraph:
    """Full dense view including the f32 cost matrix (tests / oracles)."""
    adj = build_adjacency(inst)
    return DenseGraph(A=adjacency_dense(inst), Apos=adj.Apos, eidx=adj.eidx)


def _topk_lowest_index(score: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values, ties
    broken toward the LOWEST index. ``torch.topk`` promises no tie order,
    so this is a stable descending sort, sliced."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_repulsive_edges(inst: MulticutInstance, max_neg: int,
                           threshold: float = 0.0, node_mask=None):
    """Indices of the ``max_neg`` most repulsive valid edges (+ mask).

    ``node_mask`` ((N,) bool, optional) keeps only edges with an endpoint
    in the mask: the frontier of a warm delta re-solve's first round.
    All non-candidates tie at -inf; their indices still flow into the
    windows (masked later), so the tie order must be the reference's:
    lowest index first."""
    sel = inst.edge_valid & (inst.cost < threshold)
    if node_mask is not None:
        sel = sel & (node_mask[inst.u.long()] | node_mask[inst.v.long()])
    score = torch.where(sel, -inst.cost,
                        torch.full_like(inst.cost, float("-inf")))
    k = min(max_neg, score.shape[0])
    vals, idx = _topk_lowest_index(score, k)
    return idx.to(torch.int32), vals > 0


class Triangles(NamedTuple):
    """Triangle subproblems: rows of edge indices into the instance arrays.
    Invalid rows are zeroed."""
    edges: torch.Tensor   # (T, 3) int32 edge ids
    valid: torch.Tensor   # (T,) bool


class CycleSeparationResult(NamedTuple):
    instance: MulticutInstance  # possibly with new zero-cost chord edges
    triangles: Triangles
    # all-edges CSR of ``instance`` (chords spliced in), only when the
    # caller asks (``separate(..., update_csr=True)``) on the sparse path,
    # so mode d carries its CSR across rounds instead of rebuilding it
    csr: CsrGraph | None = None


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise gather x[b, idx[b, k]] for (B, W) x and (B, K) idx."""
    return torch.gather(x, 1, idx.long())


# ---------------------------------------------------------------------------
# 3-cycles
# ---------------------------------------------------------------------------

def separate_triangles(inst: MulticutInstance, adj: DenseAdj,
                       max_neg: int, max_tri_per_edge: int,
                       node_mask=None) -> Triangles:
    """3-cycles, dense path: for each repulsive edge (i, j) up to K common
    attractive neighbours k, the K smallest ids (the reference's top_k over
    the 0/1 row AND), give triangles (ij, ik, jk)."""
    neg_idx, neg_ok = select_repulsive_edges(inst, max_neg,
                                             node_mask=node_mask)
    i = inst.u[neg_idx.long()].long()
    j = inst.v[neg_idx.long()].long()
    K = min(max_tri_per_edge, inst.num_nodes)
    common = (adj.Apos[i] & adj.Apos[j]).to(torch.float32)     # (M, N)
    vals, ks = _topk_lowest_index(common, K)
    good = (vals > 0) & neg_ok[:, None]
    e_ik = adj.eidx[i[:, None], ks]
    e_jk = adj.eidx[j[:, None], ks]
    tri = torch.stack([neg_idx[:, None].expand(-1, K), e_ik, e_jk], dim=-1)
    good = good & (e_ik >= 0) & (e_jk >= 0)
    tris = tri.reshape(-1, 3).to(torch.int32)
    goods = good.reshape(-1)
    return Triangles(edges=torch.where(goods[:, None], tris,
                                       torch.zeros_like(tris)),
                     valid=goods)


def triangles_from_windows(ci, ei, oki, cj, ej, e_, ok_, K, intersect):
    """Triangle candidates from prefetched endpoint windows: ``ci``/``ei``/
    ``oki`` the (B, W) windows of the repulsive edges' first endpoints,
    ``cj``/``ej`` the second's; ``e_``/``ok_`` the (B,) repulsive edge ids
    and masks. The first K matches (ascending node id) are the K smallest
    common neighbours."""
    Wb = ci.shape[1]
    pos = intersect(ci, cj)                 # (B, Wb) match position or -1
    pc = pos.clamp(0, Wb - 1)
    found = (pos >= 0) & oki                # mask ci's sentinel padding
    # jax.lax.top_k over the 0/1 row keeps the lowest indices among ties
    vals, idxs = _topk_lowest_index(found.to(torch.int32), K)
    good = (vals > 0) & ok_[:, None]
    e_ik = _take(ei, idxs)
    e_jk = _take(ej, _take(pc, idxs))
    tri = torch.stack([e_[:, None].expand(-1, K).to(torch.int32), e_ik,
                       e_jk], dim=-1)
    good = good & (e_ik >= 0) & (e_jk >= 0)
    return tri.reshape(-1, 3).to(torch.int32), good.reshape(-1)


def separate_triangles_sparse(inst: MulticutInstance, csr_pos: CsrGraph,
                              max_neg: int, max_tri_per_edge: int,
                              row_cap: int = 128, row_cap_short: int = 0,
                              intersect=None,
                              chunk: int = 0, shards: int = 1,
                              node_mask=None) -> Triangles:
    """3-cycles, CSR path: the common-neighbour test is a sorted-row
    intersection of the two endpoints' attractive rows. ``row_cap_short``
    > 0 splits edges into degree buckets (narrow pass + chunk-gated wide
    pass), bit-identical to the single-cap path."""
    if intersect is None:
        intersect = intersect_rows_ref
    N = inst.num_nodes
    K = min(max_tri_per_edge, N)
    W = max(K, min(row_cap, N))
    Ws = max(K, min(row_cap_short, N)) if row_cap_short > 0 else W
    neg_idx, neg_ok = select_repulsive_edges(inst, max_neg,
                                             node_mask=node_mask)
    i = inst.u[neg_idx.long()]
    j = inst.v[neg_idx.long()]

    def make_batch(Wb):
        def batch(csr_pos, i_, j_, e_, ok_):
            ci, ei, oki = csr_row_window(csr_pos, i_, Wb)     # (B, Wb) each
            cj, ej, _ = csr_row_window(csr_pos, j_, Wb)
            return triangles_from_windows(ci, ei, oki, cj, ej, e_, ok_, K,
                                          intersect)
        return batch

    if Ws >= W:
        tris, goods = _map_repulsive_batches(make_batch(W), csr_pos,
                                             (i, j, neg_idx, neg_ok),
                                             chunk, shards)
    else:
        deg = csr_pos.degrees
        is_long = (deg[i.long()] > Ws) | (deg[j.long()] > Ws)
        out_s = _map_repulsive_batches(
            make_batch(Ws), csr_pos, (i, j, neg_idx, neg_ok & ~is_long),
            chunk, shards)
        out_l = _run_long_bucket(
            make_batch(W), csr_pos, (i, j, neg_idx, neg_ok & is_long),
            is_long, chunk, shards, Ws, W)
        tris, goods = _combine_buckets(is_long, out_s, out_l)
    return Triangles(edges=torch.where(goods[:, None], tris,
                                       torch.zeros_like(tris)),
                     valid=goods)


# ---------------------------------------------------------------------------
# Chord allocation
# ---------------------------------------------------------------------------

class ChordAlloc(NamedTuple):
    instance: MulticutInstance  # with chords written into free slots
    eid: torch.Tensor       # (M,) chord edge id per request or -1
    ok: torch.Tensor        # (M,) request satisfied
    add_u: torch.Tensor     # (M,) lo endpoint per request
    add_v: torch.Tensor     # (M,) hi endpoint per request
    add_eid: torch.Tensor   # (M,) allocated slot (edge id) per fresh chord
    add_ok: torch.Tensor    # (M,) request allocated a fresh slot


def _alloc_chords(inst: MulticutInstance, exists_eid, ch_u, ch_v,
                  ch_ok) -> ChordAlloc:
    """Allocate chord edges (cost 0) from free padded slots; reuse existing
    edges where the chord already exists. Duplicates within the batch
    resolve to the first requester's slot, and fresh slots are packed in
    request order — deterministic for a fixed request order."""
    E = inst.num_edges
    M = ch_u.shape[0]
    dev = ch_u.device
    lo = torch.minimum(ch_u, ch_v)
    hi = torch.maximum(ch_u, ch_v)
    exists = exists_eid >= 0
    need = ch_ok & ~exists & (lo != hi)
    # dedupe within the batch: keep the first occurrence of each (lo, hi).
    # reference: jnp.lexsort((kh, kl)) — chained stable sorts here, so runs
    # keep request order and the run head IS the first occurrence
    sent = torch.full_like(lo, 2 ** 31 - 1)
    kl = torch.where(need, lo, sent)
    kh = torch.where(need, hi, sent)
    order = lexsort((kh, kl))
    kl_s, kh_s = kl[order], kh[order]
    run_head = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (kl_s[1:] != kl_s[:-1]) | (kh_s[1:] != kh_s[:-1])])
    run = torch.cumsum(run_head.to(torch.int32), 0) - 1
    head_of_run = segment_min(order.to(torch.int32), run, M)
    first_idx = torch.zeros(M, dtype=torch.int32, device=dev)
    first_idx[order] = head_of_run[run.long()]
    ar_m = torch.arange(M, dtype=torch.int32, device=dev)
    fresh = need & (first_idx == ar_m)

    # assign free slots: rank the fresh chords and map rank -> index of the
    # rank-th free slot
    free = ~inst.edge_valid
    ar_e = torch.arange(E, dtype=torch.int32, device=dev)
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    slot_of_rank = segment_max(torch.where(free, ar_e, -1),
                               torch.where(free, free_rank, E - 1), E)
    slot_of_rank = torch.maximum(slot_of_rank, torch.full_like(ar_e, -1))
    want_rank = torch.cumsum(fresh.to(torch.int32), 0) - 1
    n_free = free.sum()
    fits = want_rank < n_free
    ok_alloc = fresh & fits
    # JAX clamps the gather index into range; torch would fault
    slot = torch.where(ok_alloc,
                       slot_of_rank[want_rank.clamp(0, E - 1).long()],
                       torch.full_like(want_rank, E - 1))

    # per-slot incoming values (each allocated slot written by exactly one
    # fresh chord; -1 marks "no allocation")
    new_u = segment_max(torch.where(ok_alloc, lo, -1), slot, E)
    new_v = segment_max(torch.where(ok_alloc, hi, -1), slot, E)
    alloc_here = new_u >= 0
    u2 = torch.where(alloc_here, new_u, inst.u).to(torch.int32)
    v2 = torch.where(alloc_here, new_v, inst.v).to(torch.int32)
    c2 = torch.where(alloc_here, torch.zeros_like(inst.cost), inst.cost)
    ev2 = inst.edge_valid | alloc_here
    inst2 = MulticutInstance(u=u2, v=v2, cost=c2, edge_valid=ev2,
                             node_valid=inst.node_valid)

    fi = first_idx.long()
    own = torch.where(need & ok_alloc[fi], slot[fi],
                      torch.full_like(slot, -1))
    chord_eid = torch.where(exists, exists_eid, own).to(torch.int32)
    chord_ok = ch_ok & (chord_eid >= 0) & (lo != hi)
    return ChordAlloc(instance=inst2, eid=chord_eid, ok=chord_ok,
                      add_u=lo, add_v=hi, add_eid=slot, add_ok=ok_alloc)


# ---------------------------------------------------------------------------
# 4/5-cycles
# ---------------------------------------------------------------------------

def _assemble_cycles45(v0, v4, b1, b2, b3, is4, found, lookup,
                       ch1, ch1_ok, ch2, ch2_ok):
    """Chord-triangulate the best pair per repulsive edge into triangle
    rows. ``lookup(a, b)`` resolves an original edge id (CSR bisect)."""
    e = lookup
    t4a = torch.stack([e(v0, b1), ch1, e(v4, v0)], dim=-1)
    t4b = torch.stack([e(b1, b3), e(b3, v4), ch1], dim=-1)
    ok4 = found & is4 & ch1_ok
    t5b = torch.stack([e(b1, b2), ch2, ch1], dim=-1)
    t5c = torch.stack([e(b2, b3), e(b3, v4), ch2], dim=-1)
    ok5 = found & ~is4 & ch1_ok & ch2_ok

    tris = torch.cat([t4a, t4b, t5b, t5c], dim=0).to(torch.int32)
    oks = torch.cat([ok4 | ok5, ok4, ok5, ok5], dim=0)
    oks = oks & (tris >= 0).all(dim=-1)
    tris = torch.where(oks[:, None], tris, torch.zeros_like(tris))
    return Triangles(edges=tris, valid=oks)


def _alloc_and_assemble(inst: MulticutInstance, lookup, v0, v4, b1, b2, b3,
                        is4, found, splice_into: CsrGraph | None = None,
                        ) -> CycleSeparationResult:
    """Resolve the winning pairs' chords in canonical (repulsive-edge-index,
    chord-kind) order — chord 1 = (v1, v4) and chord 2 = (v2, v4)
    interleaved in ONE batch — then triangulate. ``splice_into`` (the
    caller's all-edges CSR of ``inst``) also splices the fresh chords into
    that CSR, equal to rebuilding it from the chorded instance."""
    lo1, hi1 = torch.minimum(b1, v4), torch.maximum(b1, v4)
    lo2, hi2 = torch.minimum(b2, v4), torch.maximum(b2, v4)
    ex = torch.stack([lookup(lo1, hi1), lookup(lo2, hi2)], dim=1).reshape(-1)
    ch_u = torch.stack([b1, b2], dim=1).reshape(-1)
    ch_v = torch.stack([v4, v4], dim=1).reshape(-1)
    need = torch.stack([found, found & ~is4], dim=1).reshape(-1)
    a = _alloc_chords(inst, ex, ch_u, ch_v, need)
    eid = a.eid.reshape(-1, 2)
    ok = a.ok.reshape(-1, 2)
    tri = _assemble_cycles45(v0, v4, b1, b2, b3, is4, found, lookup,
                             eid[:, 0], ok[:, 0], eid[:, 1], ok[:, 1])
    csr2 = None
    if splice_into is not None:
        no_drop = torch.zeros(inst.num_edges, dtype=torch.bool,
                              device=inst.u.device)
        csr2 = splice_csr(splice_into, no_drop, a.add_u, a.add_v,
                          a.add_eid, a.add_ok)
    return CycleSeparationResult(instance=a.instance, triangles=tri,
                                 csr=csr2)


def _pad_batch_axis(a, pad: int):
    """Zero-pad an edge arg along its leading (batch) axis only."""
    if pad == 0:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))], dim=0)


def _map_repulsive_batches(fn, consts, edge_args, chunk: int, shards: int):
    """Stream a per-repulsive-edge candidate function over the batch axis
    in chunks of ``chunk`` edges (``chunk <= 0``: the whole batch at once).
    ``fn`` treats edges independently, so the output equals the
    whole-batch call for every chunk size and shard count.

    ``shards`` > 1 (resolved by :func:`separate`) pads the batch to a
    multiple of S·C (with ``chunk <= 0``, C = ⌈M/S⌉: one chunk per shard)
    and gives shard r the contiguous rows [r·Mp/S, (r+1)·Mp/S) on its
    device, with its own copy of ``consts``; it scans its own chunks, and
    the outputs come back to the batch's device in edge order."""
    M = edge_args[0].shape[0]
    C = M if chunk <= 0 else max(1, min(chunk, M))
    S = shards
    if S > 1 and chunk <= 0:
        C = -(-M // S)
    if S == 1 and C >= M:
        return fn(consts, *edge_args)
    Mp = -(-M // (S * C)) * (S * C)
    padded = tuple(_pad_batch_axis(a, Mp - M) for a in edge_args)
    home = padded[0].device
    per = Mp // S
    shard_outs = []
    for r, dev in enumerate(_dist.shard_devices(S, home)):
        local = tuple(a[r * per:(r + 1) * per].to(dev) for a in padded)
        cst = tree_map(lambda x: x.to(dev), consts)
        shard_outs.append([fn(cst, *(a[s:s + C] for a in local))
                           for s in range(0, per, C)])
    outs = [tuple(y.to(home) for y in o) for so in shard_outs for o in so]
    cat = tuple(torch.cat(ys, dim=0) for ys in zip(*outs))
    return tuple(y[: (y.shape[0] // Mp) * M] for y in cat)


# ---------------------------------------------------------------------------
# Two-level degree bucketing (see the reference's note above
# _combine_buckets: edges whose rows fit a narrow window take the narrow
# pass; the rest re-run the exact wide computation, so the combined result
# equals the single-cap path)
# ---------------------------------------------------------------------------

def _combine_buckets(is_long, out_s, out_l):
    """Per-edge select between the short- and long-bucket outputs (k
    outputs per edge, edge-major). ``out_l`` is None when no edge is
    long."""
    if out_l is None:
        return out_s
    M = is_long.shape[0]

    def sel(s, l):
        k = s.shape[0] // M
        m = torch.repeat_interleave(is_long, k) if k > 1 else is_long
        return torch.where(m.reshape((s.shape[0],) + (1,) * (s.dim() - 1)),
                           l, s)

    return tuple(sel(s, l) for s, l in zip(out_s, out_l))


def _map_long_chunks(fn, consts, edge_args, is_long, chunk: int):
    """Long-bucket streamer: run ``fn`` only on chunks holding at least one
    long edge; skipped chunks emit zeros, which :func:`_combine_buckets`
    never reads (None when no chunk runs). The skip is data-dependent, so
    it costs one host sync per call (site ``long_bucket``): all chunks'
    flags are read at once."""
    M = edge_args[0].shape[0]
    C = max(1, min(chunk, M))
    Mp = -(-M // C) * C
    padded = tuple(_pad_batch_axis(a, Mp - M) for a in edge_args)
    lng = _pad_batch_axis(is_long, Mp - M)
    n_chunks = Mp // C
    has_long = lng.reshape(n_chunks, C).any(dim=1).tolist()
    obs.count_sync("long_bucket", lng.device)
    if not any(has_long):
        return None
    outs = [fn(consts, *(a[c * C:(c + 1) * C] for a in padded))
            if run else None for c, run in enumerate(has_long)]
    proto = next(o for o in outs if o is not None)
    zeros = tuple(torch.zeros_like(y) for y in proto)
    cat = tuple(torch.cat(ys, dim=0)
                for ys in zip(*(zeros if o is None else o for o in outs)))
    return tuple(y[: (y.shape[0] // Mp) * M] for y in cat)


def _run_long_bucket(fn, consts, edge_args, is_long, chunk: int, shards: int,
                     w_short: int, w_long: int):
    """Long-bucket pass at the wide window, chunk size scaled by
    w_short/w_long so its per-chunk element budget matches the short
    pass. Sharded runs take the ungated streamer, as the reference does:
    the gate is a data-dependent skip (a host sync) that would break the
    static shard split; only long lanes are ever read either way."""
    M = edge_args[0].shape[0]
    base = chunk if chunk > 0 else M
    C = max(1, (base * w_short) // w_long)
    if shards > 1:
        return _map_repulsive_batches(fn, consts, edge_args, C, shards)
    return _map_long_chunks(fn, consts, edge_args, is_long, C)


def separate_cycles45(inst: MulticutInstance, adj: DenseAdj, max_neg: int,
                      nbr_k: int = 4,
                      node_mask=None) -> CycleSeparationResult:
    """4/5-cycles per Alg. 5, dense path: for repulsive edge (v0, v4), scan
    pairs (v1, v3) ∈ N⁺(v0) × N⁺(v4); a 4-cycle needs v1v3 ∈ E⁺, a 5-cycle
    a common attractive neighbour v2 (a row-dot of ``A⁺``). The best pair
    per repulsive edge is triangulated with zero-cost chords.

    The reference casts the whole (N, N) ``A⁺`` to float32 and gathers its
    rows; here only the gathered rows are cast (same values, no (N, N)
    float copy). The (M, nbr_k, N) × (M, N, nbr_k) pair product counts 0/1
    products, exact in float32, so ``torch.matmul`` gives the reference's
    counts."""
    N = inst.num_nodes
    nbr_k = min(nbr_k, N)
    neg_idx, neg_ok = select_repulsive_edges(inst, max_neg,
                                             node_mask=node_mask)
    v0 = inst.u[neg_idx.long()]
    v4 = inst.v[neg_idx.long()]
    Apos = adj.Apos
    M = v0.shape[0]
    dev = v0.device

    def rows(nodes):
        return Apos[nodes.long()].to(torch.float32)

    w0, n0 = _topk_lowest_index(rows(v0), nbr_k)        # (M, nbr_k)
    w4, n4 = _topk_lowest_index(rows(v4), nbr_k)
    ok0 = w0 > 0
    ok4 = w4 > 0
    pair_ok = ok0[:, :, None] & ok4[:, None, :] & neg_ok[:, None, None]
    v1 = n0[:, :, None].expand(M, nbr_k, nbr_k)
    v3 = n4[:, None, :].expand(M, nbr_k, nbr_k)
    distinct = (v1 != v3) & (v1 != v4[:, None, None].long()) & \
        (v3 != v0[:, None, None].long())
    is4 = pair_ok & distinct & Apos[v1, v3]
    pair_counts = torch.matmul(rows(n0), rows(n4).transpose(1, 2))
    is5 = pair_ok & distinct & ~is4 & (pair_counts > 0)
    two = torch.full(is4.shape, 2.0, device=dev)
    one = torch.full(is4.shape, 1.0, device=dev)
    ninf = torch.full(is4.shape, float("-inf"), device=dev)
    # prefer 4-cycles, then the strongest attractive support
    score = torch.where(is4, two, torch.where(is5, one, ninf)) \
        + torch.minimum(w0[:, :, None], w4[:, None, :]) * 1e-3
    # jnp.argmax and torch.argmax both take the FIRST maximum
    flat = torch.argmax(score.reshape(M, -1), dim=1)
    bi, bj = flat // nbr_k, flat % nbr_k
    m = torch.arange(M, device=dev)
    found = score.reshape(M, -1)[m, flat] > float("-inf")
    b1 = n0[m, bi]
    b3 = n4[m, bj]
    b_is4 = is4[m, bi, bj]
    # v2 = the smallest common attractive neighbour of (v1, v3) other than
    # the repulsive endpoints
    common = (Apos[b1] & Apos[b3]).to(torch.float32)
    common.scatter_(1, v0[:, None].long(), 0.0)
    common.scatter_(1, v4[:, None].long(), 0.0)
    b2 = torch.argmax(common, dim=1)
    has_v2 = common[m, b2] > 0
    found = found & (b_is4 | has_v2)
    return _alloc_and_assemble(
        inst, lambda a, b: adj.eidx[a.long(), b.long()], v0, v4,
        b1.to(torch.int32), b2.to(torch.int32), b3.to(torch.int32), b_is4,
        found)


def separate_cycles45_sparse(inst: MulticutInstance, csr_pos: CsrGraph,
                             csr_all: CsrGraph, max_neg: int, nbr_k: int = 4,
                             row_cap: int = 128, row_cap_short: int = 0,
                             intersect=None,
                             chunk: int = 0, shards: int = 1,
                             node_mask=None,
                             splice_into: CsrGraph | None = None,
                             ) -> CycleSeparationResult:
    """4/5-cycles, CSR path (mirrors the dense scan pair for pair):
    neighbour fans are the first ``nbr_k`` entries of each sorted attractive
    row; v1v3 ∈ E⁺ is membership of v3 in v1's window; 2-path existence is
    sorted-row intersection of the fan nodes' windows; v2 is the first
    surviving element of the winning pair's intersection."""
    if intersect is None:
        intersect = intersect_rows_ref
    N = inst.num_nodes
    nbr_k = min(nbr_k, N)
    W = max(1, min(row_cap, N))
    Ws = max(1, min(row_cap_short, N)) if row_cap_short > 0 else W
    neg_idx, neg_ok = select_repulsive_edges(inst, max_neg,
                                             node_mask=node_mask)
    v0 = inst.u[neg_idx.long()]
    v4 = inst.v[neg_idx.long()]
    n0, _, ok0 = csr_row_window(csr_pos, v0, nbr_k)     # (M, nbr_k)
    n4, _, ok4 = csr_row_window(csr_pos, v4, nbr_k)

    def make_candidates(Wb):
        def candidates(csr_pos, v0_, v4_, n0_, n4_, ok0_, ok4_, ok_):
            B = v0_.shape[0]
            dev = v0_.device
            # windows of every fan node's attractive row: (B, nbr_k, Wb)
            r1c, _, r1ok = csr_row_window(csr_pos, n0_, Wb)
            r3c, _, _ = csr_row_window(csr_pos, n4_, Wb)

            # 2-path existence for every (v1, v3) pair, looped over the j
            # fan so only (B·nbr_k, Wb) windows are live at once
            ci_flat = r1c.reshape(B * nbr_k, Wb)
            oki_flat = r1ok.reshape(B * nbr_k, Wb)
            has2 = []
            for jj in range(nbr_k):
                cj_j = r3c[:, None, jj, :].expand(B, nbr_k, Wb) \
                    .reshape(B * nbr_k, Wb)
                pos_j = intersect(ci_flat, cj_j)
                has2.append(((pos_j >= 0) & oki_flat).any(dim=-1)
                            .reshape(B, nbr_k))
            has2path = torch.stack(has2, dim=-1)        # (B, nbr_k, nbr_k)

            v1 = n0_[:, :, None].expand(B, nbr_k, nbr_k)
            v3 = n4_[:, None, :].expand(B, nbr_k, nbr_k)
            # v1v3 ∈ E⁺ ⇔ v3 appears in v1's window: the (unsorted) v4-fan
            # against r1c; invalid fan slots carry the N sentinel on both
            # sides and are masked by pair_ok below
            fan3 = n4_[:, None, :].expand(B, nbr_k, nbr_k) \
                .reshape(B * nbr_k, nbr_k)
            e13pos = intersect(fan3, ci_flat).reshape(B, nbr_k, nbr_k)

            pair_ok = ok0_[:, :, None] & ok4_[:, None, :] & ok_[:, None, None]
            distinct = (v1 != v3) & (v1 != v4_[:, None, None]) & \
                (v3 != v0_[:, None, None])
            is4 = pair_ok & distinct & (e13pos >= 0)
            is5 = pair_ok & distinct & ~is4 & has2path
            w0 = ok0_.to(torch.float32)
            w4 = ok4_.to(torch.float32)
            two = torch.full(is4.shape, 2.0, device=dev)
            one = torch.full(is4.shape, 1.0, device=dev)
            ninf = torch.full(is4.shape, float("-inf"), device=dev)
            score = torch.where(is4, two, torch.where(is5, one, ninf)) \
                + torch.minimum(w0[:, :, None], w4[:, None, :]) * 1e-3
            # jnp.argmax and torch.argmax both take the FIRST maximum
            flat = torch.argmax(score.reshape(B, -1), dim=1)
            bi, bj = flat // nbr_k, flat % nbr_k
            m = torch.arange(B, device=dev)
            found = score.reshape(B, -1)[m, flat] > float("-inf")
            b1 = n0_[m, bi]
            b3 = n4_[m, bj]
            b_is4 = is4[m, bi, bj]
            # v2 = smallest common attractive neighbour of (b1, b3) other
            # than the repulsive endpoints: re-intersect the winning pair
            win_cols = r1c[m, bi]                               # (B, Wb)
            win_pos = intersect(win_cols, r3c[m, bj])
            win_common = (win_pos >= 0) & r1ok[m, bi] & \
                (win_cols != v0_[:, None]) & (win_cols != v4_[:, None])
            has_v2 = win_common.any(dim=1)
            first = torch.argmax(win_common.to(torch.int32), dim=1)
            b2 = torch.where(has_v2, win_cols[m, first],
                             torch.zeros_like(b1)).to(torch.int32)
            found = found & (b_is4 | has_v2)
            return (b1.to(torch.int32), b2, b3.to(torch.int32), b_is4,
                    found)
        return candidates

    if Ws >= W:
        b1, b2, b3, is4, found = _map_repulsive_batches(
            make_candidates(W), csr_pos,
            (v0, v4, n0, n4, ok0, ok4, neg_ok), chunk, shards)
    else:
        # an edge is long iff ANY window it reads overflows the short cap
        deg = csr_pos.degrees
        zero = torch.zeros_like(deg[:1])
        dl0 = torch.where(ok0, deg[n0.long().clamp(0, N - 1)], zero)
        dl4 = torch.where(ok4, deg[n4.long().clamp(0, N - 1)], zero)
        is_long = (dl0.max(dim=1).values > Ws) | \
            (dl4.max(dim=1).values > Ws)
        out_s = _map_repulsive_batches(
            make_candidates(Ws), csr_pos,
            (v0, v4, n0, n4, ok0, ok4, neg_ok & ~is_long), chunk, shards)
        out_l = _run_long_bucket(
            make_candidates(W), csr_pos,
            (v0, v4, n0, n4, ok0, ok4, neg_ok & is_long),
            is_long, chunk, shards, Ws, W)
        b1, b2, b3, is4, found = _combine_buckets(is_long, out_s, out_l)
    return _alloc_and_assemble(inst,
                               lambda a, b: csr_lookup_edge(csr_all, a, b),
                               v0, v4, b1, b2, b3, is4, found,
                               splice_into=splice_into)


# ---------------------------------------------------------------------------
# Full separation round
# ---------------------------------------------------------------------------

def separate(inst: MulticutInstance, max_neg: int, max_tri_per_edge: int,
             with_cycles45: bool = True, nbr_k: int = 4,
             graph_impl: str = "dense", sparse_row_cap: int = 128,
             sparse_row_cap_short: int = 0,
             sparse_threshold: int = DEFAULT_SPARSE_THRESHOLD, intersect=None,
             csr: CsrGraph | None = None, separation_chunk: int = 0,
             separation_shards: int = 1, sep_node_mask=None,
             update_csr: bool = False) -> CycleSeparationResult:
    """Full separation round: 3-cycles always; 4/5-cycles optionally.

    ``graph_impl`` selects the data path ("auto" flips to CSR above
    ``sparse_threshold`` padded nodes). On the sparse path ``csr`` is the
    caller's live all-edges CSR of ``inst``; the attractive E⁺ view is a
    sort-free :func:`csr_filter` over it (one ``build_csr`` here when
    absent). ``intersect`` swaps the sorted-row intersection (None = plain
    version, or the cycle_intersect kernel wrapper). ``update_csr`` asks
    the sparse path to return that CSR with the round's fresh chords
    spliced in (``result.csr``). ``sep_node_mask`` ((N,) bool, optional)
    restricts repulsive-edge selection to edges touching the mask on both
    paths (warm delta re-solves). ``separation_shards`` is clamped to the
    cards present here, once; the sparse helpers take the count as given.
    The dense path ignores ``csr``, ``intersect``, the row caps, the
    chunking and the shards."""
    impl = resolve_graph_impl(graph_impl, inst.num_nodes, sparse_threshold)
    separation_shards = _dist.resolve_separation_shards(separation_shards)
    if impl == "dense":
        adj = build_adjacency(inst)
        tri3 = separate_triangles(inst, adj, max_neg, max_tri_per_edge,
                                  node_mask=sep_node_mask)
        if not with_cycles45:
            return CycleSeparationResult(instance=inst, triangles=tri3)
        res45 = separate_cycles45(inst, adj, max_neg, nbr_k=nbr_k,
                                  node_mask=sep_node_mask)
    else:
        csr_all = csr_from_instance(inst) if csr is None else csr
        csr_pos = csr_filter(csr_all, inst.edge_valid & (inst.cost > 0))
        tri3 = separate_triangles_sparse(inst, csr_pos, max_neg,
                                         max_tri_per_edge,
                                         row_cap=sparse_row_cap,
                                         row_cap_short=sparse_row_cap_short,
                                         intersect=intersect,
                                         chunk=separation_chunk,
                                         shards=separation_shards,
                                         node_mask=sep_node_mask)
        if not with_cycles45:
            return CycleSeparationResult(
                instance=inst, triangles=tri3,
                csr=csr_all if update_csr else None)
        res45 = separate_cycles45_sparse(
            inst, csr_pos, csr_all, max_neg, nbr_k=nbr_k,
            row_cap=sparse_row_cap, row_cap_short=sparse_row_cap_short,
            intersect=intersect, chunk=separation_chunk,
            shards=separation_shards, node_mask=sep_node_mask,
            splice_into=csr_all if update_csr else None)
    edges = torch.cat([tri3.edges, res45.triangles.edges], dim=0)
    valid = torch.cat([tri3.valid, res45.triangles.valid], dim=0)
    return CycleSeparationResult(
        instance=res45.instance,
        triangles=Triangles(edges=edges, valid=valid), csr=res45.csr)
