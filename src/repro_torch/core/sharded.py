"""Fully sharded solve: the edge-range-partitioned solver state (port of
``repro.core.sharded``).

The replicated sparse solve (``solver._solve_pd_device``) keeps the whole
padded instance and CSR on one device. This module runs the same PD
recursion with every per-edge leaf partitioned by contiguous edge range
over the state group (:func:`repro_torch.core.dist.state_group`): rank s
owns ``[s * E/S, (s+1) * E/S)`` of u/v/cost/edge_valid and a CSR of its own
edges (LOCAL edge ids) for the life of the solve; per-node arrays
(node_valid, labels, the original→cluster mapping) are the same on every
rank.

The reference wraps its round loop in one ``shard_map``; the port is SPMD:
every rank runs the loop below on its range, and the collectives of
:mod:`repro_torch.core.dist` join them. Each round:

  separation  — repulsive-edge selection is a two-level top-k (per-rank
                top-k, all_gather, final top-k; the gather order keeps the
                replicated lowest-index tie-break); CSR row windows are
                merged across ranks by one stable argsort per query
                batch; the triangles come from the replicated
                :func:`~repro_torch.core.cycles.triangles_from_windows`
                with the ``cycle_intersect`` kernel on the card.
  MP          — ``message_passing.run_message_passing_sharded``: one
                halo exchange of the triangles' slot costs, then the
                fused ``triangle_mp`` phase on compact triangle-edge ids.
  contraction — :func:`~repro_torch.core.contraction.contract_sharded`:
                two exchanges merge parallel edges across range cuts.

Every branch of the loop (the CC convergence test, the early exit on a
round that contracts nothing) reads a value a collective has made the
same on every rank, so the ranks stay in lockstep.

BIT-IDENTITY: every per-edge array the loop carries is the exact local
slice of what the replicated sparse solve carries, so labels, rounds and
histories equal the replicated path's for every shard count. The
reported scalars (bound, objective, trace gains) go through
:func:`~repro_torch.core.dist.blocked_sum` and
:func:`~repro_torch.core.dist.tree_sum`: identical across shard counts,
and within float rounding of the replicated path's sums.

Constraints (:func:`validate_state_sharded`): mode pd, 3-cycle separation
only, the sparse data path, padded E divisible by ``dist.STATE_BLOCKS``,
E < 2^30, no separation chunking or sharding on top.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.contraction import choose_contraction_set_sharded, \
    contract_sharded
from repro_torch.core.cycles import _topk_lowest_index, \
    triangles_from_windows
from repro_torch.core.dist import (
    STATE_BLOCKS, all_gather, blocked_sum, broadcast, edge_range_start,
    gather_edge_field, resolve_state_shards, state_group,
)
from repro_torch.core.graph import (
    EdgeRange, build_csr, csr_filter, csr_row_window, resolve_graph_impl,
)
from repro_torch.core.message_passing import run_message_passing_sharded
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref
from repro_torch.obs.trace import init_trace, trace_set_round


def validate_state_sharded(inst, cfg, mode: str) -> int:
    """Preconditions of the sharded solve; returns the resolved shard
    count. ``inst`` is the full instance or this rank's
    :class:`~repro_torch.core.graph.EdgeRange` (whose global E is its
    range times the shard count)."""
    shards = resolve_state_shards(cfg.state_shards)
    E, N = inst.num_edges, inst.num_nodes
    if isinstance(inst, EdgeRange):
        E *= shards
    if mode != "pd":
        raise ValueError(
            f"state_shards requires mode='pd' (got {mode!r}); the sharded "
            f"solve supports 3-cycle separation only, which rules out "
            f"pd+/d, and p has no dual state to shard")
    if cfg.always_cycles45 or cfg.first_round_cycles45:
        raise ValueError(
            "state_shards supports 3-cycle separation only; set "
            "first_round_cycles45=False (and always_cycles45=False) — "
            "4/5-cycle chord splicing grows the edge set, which a "
            "fixed edge-range partition cannot absorb")
    if resolve_graph_impl(cfg.graph_impl, N, cfg.sparse_threshold) \
            != "sparse":
        raise ValueError(
            f"state_shards runs the CSR data path only; graph_impl="
            f"{cfg.graph_impl!r} resolves dense at N={N} (threshold "
            f"{cfg.sparse_threshold}) — pass graph_impl='sparse'")
    if cfg.separation_shards > 1 or cfg.separation_chunk > 0:
        raise ValueError(
            "state_shards already partitions separation by edge range; "
            "it does not stack with separation_shards/separation_chunk")
    if E % STATE_BLOCKS:
        raise ValueError(
            f"state_shards needs pad_edges divisible by {STATE_BLOCKS} "
            f"(dist.STATE_BLOCKS, the shard-count-invariant reduction "
            f"ranges); got E={E}. graph.round_up_edges picks a valid pad")
    if E >= 2 ** 30:
        raise ValueError(
            f"state_shards tie-break keys use direction * E + edge_id in "
            f"int32, requiring E < 2^30; got E={E}. Split the instance or "
            f"widen the key policy first")
    return shards


# ---------------------------------------------------------------------------
# Sharded separation (3-cycles)
# ---------------------------------------------------------------------------

def _select_repulsive_sharded(cost_loc, ev_loc, max_neg: int, shards: int,
                              group):
    """Sharded :func:`~repro_torch.core.cycles.select_repulsive_edges`:
    per-rank top-k of the local scores, all_gathered in rank order and
    topped again. Rank order is ascending global id among equal values,
    so the final top-k keeps the replicated lowest-index tie-break; every
    global top-M edge is in its rank's top-k (it has fewer than M ≤ k
    predecessors there). Returns (global edge ids int32, ok mask), the
    same on every rank."""
    E_loc = cost_loc.shape[0]
    sel = ev_loc & (cost_loc < 0.0)
    score = torch.where(sel, -cost_loc,
                        torch.full_like(cost_loc, float("-inf")))
    vals, lidx = _topk_lowest_index(score, min(max_neg, E_loc))
    gidx = edge_range_start(E_loc, group) + lidx
    gv = all_gather(vals, group).reshape(-1)
    gi = all_gather(gidx, group).reshape(-1)
    fv, fpos = _topk_lowest_index(gv, min(max_neg, E_loc * shards))
    return gi[fpos].to(torch.int32), fv > 0


def _merged_windows(csr_loc, nodes, cap: int, group):
    """The global CSR row windows of ``nodes``, merged from the ranks'
    local windows: each rank gives the first ``cap`` entries of its own
    row slice (LOCAL edge ids lifted to global), one stable argsort by
    neighbour id merges them. Neighbour ids are distinct within a row of
    the simple graph, so sorting by column alone gives the replicated
    (col, edge id) order, and an entry of the global first-``cap`` window
    has fewer than ``cap`` predecessors on its own rank, so none is cut.
    Returns (cols, global eids, ok), shaped like ``csr_row_window``'s."""
    N = csr_loc.num_nodes
    E_loc = csr_loc.col.shape[0] // 2
    c, e, ok = csr_row_window(csr_loc, nodes, cap)      # (B, cap) local
    ge = torch.where(ok, e + edge_range_start(E_loc, group),
                     torch.full_like(e, -1))
    B = nodes.shape[0]
    cols = all_gather(c, group).transpose(0, 1).reshape(B, -1)
    eids = all_gather(ge, group).transpose(0, 1).reshape(B, -1)
    order = torch.argsort(cols, dim=1, stable=True)[:, :cap]
    cols_s = torch.gather(cols, 1, order)
    return cols_s, torch.gather(eids, 1, order), cols_s < N


def _separate_triangles_state_sharded(u_loc, v_loc, cost_loc, ev_loc,
                                      csr_loc, num_nodes: int, cfg,
                                      shards: int, group, intersect,
                                      with_aux: bool = False):
    """Sharded 3-cycle separation over the carried local CSR: the local
    attractive view is a sort-free ``csr_filter``, the candidate windows
    merge across ranks, the triangles come from the replicated
    :func:`triangles_from_windows`. Returns (tri, valid), the same on
    every rank and equal to the replicated separation's; ``with_aux``
    also returns the repulsive anchors (neg_idx, neg_ok) for the trace."""
    if intersect is None:
        intersect = intersect_rows_ref
    csr_pos = csr_filter(csr_loc, ev_loc & (cost_loc > 0))
    neg_idx, neg_ok = _select_repulsive_sharded(cost_loc, ev_loc,
                                                cfg.max_neg, shards, group)
    i = gather_edge_field(u_loc, neg_idx, group)
    j = gather_edge_field(v_loc, neg_idx, group)
    K = min(cfg.max_tri_per_edge, num_nodes)
    W = max(K, min(cfg.sparse_row_cap, num_nodes))
    ci, ei, oki = _merged_windows(csr_pos, i, W, group)
    cj, ej, _ = _merged_windows(csr_pos, j, W, group)
    tris, goods = triangles_from_windows(ci, ei, oki, cj, ej, neg_idx,
                                         neg_ok, K, intersect)
    tris = torch.where(goods[:, None], tris, torch.zeros_like(tris))
    if with_aux:
        return tris, goods, neg_idx, neg_ok
    return tris, goods


# ---------------------------------------------------------------------------
# The sharded PD round + solve loop
# ---------------------------------------------------------------------------

def _sharded_pd_round(u_loc, v_loc, cost_loc, ev_loc, node_valid, csr_loc,
                      cfg, shards: int, group, mp=None, intersect=None,
                      with_aux: bool = False):
    """One PD round on the edge-range state, the sharded mirror of
    ``solver.fused_pd_round_state`` (3-cycles only). Returns the
    :class:`~repro_torch.core.contraction.ShardedContraction` and the
    round's bound.

    ``with_aux`` appends ``(n_cycles, mp_improvement, shard_edges,
    shard_topk, shard_halo)``: conflicted cycles, the MP bound's gain over
    the trivial edge bound, and the (S,) per-rank balance: live edges
    owned entering the round, repulsive-anchor slots won in the global
    top-k, and triangle-slot edge references landing on each rank. The
    gain goes through :func:`blocked_sum`, identical across shard counts."""
    N = node_valid.shape[0]
    E_loc = u_loc.shape[0]
    with obs.phase("separation", range="repro.separation"):
        sep = _separate_triangles_state_sharded(
            u_loc, v_loc, cost_loc, ev_loc, csr_loc, N, cfg, shards, group,
            intersect, with_aux=with_aux)
        tri, tri_ok = sep[0], sep[1]
    with obs.phase("message_passing", range="repro.message_passing"):
        c_rep_loc, lb = run_message_passing_sharded(
            cost_loc, ev_loc, tri, tri_ok, cfg.mp_iters, shards, group, mp)
    with obs.phase("contraction", range="repro.contraction"):
        S_loc = choose_contraction_set_sharded(
            u_loc, v_loc, c_rep_loc, ev_loc, node_valid,
            cfg.matching_rounds, cfg.forest_rounds, cfg.switch_frac,
            cfg.contract_frac, shards, group)
        con = contract_sharded(u_loc, v_loc, c_rep_loc, ev_loc, node_valid,
                               S_loc, shards, group)
    if not with_aux:
        return con, lb
    neg_idx, neg_ok = sep[2], sep[3]
    sid = torch.arange(shards, dtype=torch.int64, device=u_loc.device)
    sh_edges = all_gather(ev_loc.sum().to(torch.int32), group)
    owner = neg_idx.long() // E_loc
    sh_topk = ((owner[:, None] == sid) & neg_ok[:, None]).sum(0) \
        .to(torch.int32)
    towner = tri.long() // E_loc
    sh_halo = ((towner[..., None] == sid) & tri_ok[:, None, None]) \
        .sum((0, 1)).to(torch.int32)
    zero = torch.zeros_like(cost_loc)
    trivial_lb = blocked_sum(torch.where(ev_loc, torch.minimum(cost_loc,
                                                               zero), zero),
                             shards, group)
    n_cyc = tri_ok.sum().to(torch.int32)
    return con, lb, (n_cyc, lb - trivial_lb, sh_edges, sh_topk, sh_halo)


def _rank_range(inst, shards: int, rank: int):
    """(u, v, cost, edge_valid) of this rank's edge range."""
    if isinstance(inst, EdgeRange):
        return inst.u, inst.v, inst.cost, inst.edge_valid
    E_loc = inst.num_edges // shards
    sl = slice(rank * E_loc, (rank + 1) * E_loc)
    return inst.u[sl], inst.v[sl], inst.cost[sl], inst.edge_valid[sl]


def _solve_rank(inst, cfg, shards: int, group, rank: int, mp, intersect,
                trace: bool):
    """The round loop on one rank of the state group."""
    from repro_torch.core.solver import SolveResult, _exit_read, \
        _host_scalar
    N, R = inst.num_nodes, cfg.max_rounds
    dev = inst.device
    u0, v0, c0, ev0 = _rank_range(inst, shards, rank)
    u0l, v0l = u0.long(), v0.long()

    def objective(mapping):
        cut = mapping[u0l] != mapping[v0l]
        return blocked_sum(torch.where(ev0 & cut, c0, torch.zeros_like(c0)),
                           shards, group)

    u, v, c, ev, nv = u0, v0, c0, ev0, inst.node_valid
    csr = build_csr(u0, v0, ev0, N)
    mapping = torch.arange(N, dtype=torch.int32, device=dev)
    hist_lb = torch.full((R,), float("-inf"), dtype=torch.float32,
                         device=dev)
    hist_nc = torch.zeros((R,), dtype=torch.int32, device=dev)
    hist_nk = torch.zeros((R,), dtype=torch.int32, device=dev)
    tr = init_trace(R, shards, device=dev) if trace else None
    lb0 = None
    r = 0
    while r < R:
        with obs.phase("round", r=r, slots=u.shape[0]) as rnd:
            if rnd:
                rnd.set(live_edges=ev.sum())
            out = _sharded_pd_round(u, v, c, ev, nv, csr, cfg, shards, group,
                                    mp, intersect, with_aux=trace)
            con, lb = out[0], out[1]
            mapping = con.mapping[mapping.long()]
            if r == 0:
                lb0 = lb
            hist_lb[r] = lb
            hist_nc[r] = con.n_contracted.to(torch.int32)
            hist_nk[r] = con.n_new.to(torch.int32)
            if trace:
                n_cyc, gain, she, shk, shh = out[2]
                trace_set_round(tr, r, lower_bound=hist_lb[r],
                                objective=objective(mapping),
                                n_cycles=n_cyc, n_contracted=hist_nc[r],
                                n_clusters=hist_nk[r], mp_improvement=gain,
                                shard_edges=she, shard_topk=shk,
                                shard_halo=shh)
            u, v, c, ev, nv, csr = (con.u2, con.v2, con.c2, con.ev2,
                                    con.node_valid, con.csr)
            r += 1
            # summed over ranks: lockstep
            done = _exit_read(con.n_contracted)
        if done:
            break
    res = SolveResult(labels=mapping, objective=objective(mapping),
                      lower_bound=lb0.to(torch.float32),
                      rounds=_host_scalar(r, torch.int32, dev),
                      lb_history=hist_lb, n_contracted=hist_nc,
                      n_clusters=hist_nk)
    return res, tr


def solve_state_sharded(inst, cfg, mode: str = "pd", mp=None,
                        intersect=None, trace: bool = False):
    """The fully sharded PD solve, called by every rank of the default
    process group (or alone, without one). ``inst`` is the full instance,
    the same on every rank, or this rank's
    :class:`~repro_torch.core.graph.EdgeRange` from
    ``make_instance_streamed(state_shards=...)``.

    The ``S`` ranks of the state group run the rounds on their edge
    ranges; ranks past ``S`` take no part in them and receive the result
    by one broadcast from rank 0, so every caller returns the same
    ``SolveResult`` (labels and histories bit-identical across shard
    counts and to the replicated sparse solve; bound and objective
    identical across shard counts). ``trace=True`` returns
    ``(SolveResult, SolveTrace)`` with the ``shard_*`` rows at width S."""
    from repro_torch.core.solver import SolveResult
    shards = validate_state_sharded(inst, cfg, mode)
    group = state_group(shards)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    if rank < shards:
        res, tr = _solve_rank(inst, cfg, shards, group, rank, mp, intersect,
                              trace)
    else:
        N, R, dev = inst.num_nodes, cfg.max_rounds, inst.device
        f32, i32 = dict(dtype=torch.float32, device=dev), \
            dict(dtype=torch.int32, device=dev)
        res = SolveResult(labels=torch.zeros(N, **i32),
                          objective=torch.zeros((), **f32),
                          lower_bound=torch.zeros((), **f32),
                          rounds=torch.zeros((), **i32),
                          lb_history=torch.zeros(R, **f32),
                          n_contracted=torch.zeros(R, **i32),
                          n_clusters=torch.zeros(R, **i32))
        tr = init_trace(R, shards, device=dev) if trace else None
    if shards < world:
        res = type(res)(*(broadcast(x, 0, dist.group.WORLD) for x in res))
        if trace:
            tr = type(tr)(*(broadcast(x, 0, dist.group.WORLD) for x in tr))
    return (res, tr) if trace else res
