"""Primal: parallel edge contraction (RAMA §3.1, Alg. 1/4).

Port of the replicated half of ``repro.core.contraction``:

* connected components — min-label propagation + pointer jumping;
* maximum matching — handshaking as mutual-argmax over segment reductions;
* maximum spanning forest — Borůvka rounds with component freezing;
* contraction — relabel endpoints by component, then ONE sort over the 2E
  directed edge copies that both merges parallel edges and emits the
  contracted graph's CSR (:func:`contract_csr`), which the solver carries
  to the next round.

Integer min/max scatters are order-free, so they use ``scatter_reduce_``.
The one float reduction (merged edge costs) runs in a fixed order, the
same on every device.

The sharded half (``*_sharded``, :func:`contract_sharded`) runs the same
arithmetic on one rank's contiguous edge range of the state group
(:mod:`repro_torch.core.dist`), bit for bit equal to the replicated half
for every shard count.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.dist import all_gather, all_max, all_min, \
    all_sum_int, blocked_sum, combine_node_best, edge_range_start
from repro_torch.core.graph import CsrGraph, MulticutInstance, \
    build_csr, csr_lookup_edge, lexsort
from repro_torch.kernels.contract_matmul.ref import contract_matmul_ref
from repro_torch.sparse.segment_ops import segment_argmax, sequential_sums

# connected_components tests for convergence every CC_CHECK_EVERY steps: a
# step after convergence is a no-op (the min-scatter and the pointer jumps
# change nothing at a fixed point), so the labels are bit-identical to the
# reference's check-every-step while_loop, with fewer host syncs
CC_CHECK_EVERY = 4


def _scatter_extreme(n: int, fill, index, src, reduce: str):
    out = torch.full((n,), fill, dtype=src.dtype, device=src.device)
    return out.scatter_reduce_(0, index.long(), src, reduce,
                               include_self=True)


# ---------------------------------------------------------------------------
# Connected components
# ---------------------------------------------------------------------------

def _propagate(labels, step, site: str):
    """Run ``step`` (labels -> labels) in blocks of ``CC_CHECK_EVERY`` until
    a block changes nothing; each block ends in one convergence check, a
    host sync (site ``cc_check``). One ``contraction.cc`` span, with the
    caller's ``site`` and the ``steps`` run."""
    with obs.phase("contraction.cc", site=site) as sp:
        checks = 0
        while True:
            prev = labels
            for _ in range(CC_CHECK_EVERY):
                labels = step(labels)
            checks += 1
            if not bool((labels != prev).any()):
                break
        obs.count_sync("cc_check", labels.device, checks)
        sp.set(steps=CC_CHECK_EVERY * checks)
    return labels


def connected_components(u, v, edge_mask, num_nodes: int,
                         site: str = "other"):
    """Min-label propagation with pointer jumping. Returns (N,) labels where
    each node's label is the smallest node id in its component (w.r.t.
    edges where ``edge_mask`` is True). ``site`` names the caller in the
    span (``forest_try``, ``forest_keep``, ``merge``).

    The reference's ``while_loop`` has no host sync; here each convergence
    test is one, so it runs every ``CC_CHECK_EVERY`` steps (see above)."""
    ul, vl = u.long(), v.long()

    def step(labels):
        lu, lv = labels[ul], labels[vl]
        m = torch.minimum(lu, lv)
        new = labels.scatter_reduce(0, ul, torch.where(edge_mask, m, lu),
                                    "amin", include_self=True)
        new = new.scatter_reduce(0, vl, torch.where(edge_mask, m, lv),
                                 "amin", include_self=True)
        new = new[new.long()]           # pointer jumping (twice)
        return new[new.long()]

    labels = torch.arange(num_nodes, dtype=torch.int32, device=u.device)
    return _propagate(labels, step, site)


# ---------------------------------------------------------------------------
# Contraction set strategies
# ---------------------------------------------------------------------------

def _node_best_positive_edge(u, v, cost, active, num_nodes: int):
    """For every node, the index of its best (max-cost) active incident edge
    (ties toward the smallest concat index). Returns (N,) edge index or
    -1."""
    E = u.shape[0]
    eidx = torch.arange(E, dtype=torch.int32, device=u.device)
    seg = torch.cat([u, v])
    val = torch.cat([cost, cost])
    msk = torch.cat([active, active])
    edge_of = torch.cat([eidx, eidx])
    arg, _ = segment_argmax(val, seg, num_nodes, mask=msk)
    return torch.where(arg >= 0, edge_of[arg.long().clamp(min=0)],
                       torch.full_like(arg, -1))


def maximum_matching(inst: MulticutInstance, rounds: int = 3,
                     min_cost=0.0):
    """Handshaking matching on attractive edges: an edge joins the matching
    when both endpoints pick it as their best incident edge. ``rounds``
    re-runs on still-free nodes to thicken the matching."""
    N, E = inst.num_nodes, inst.num_edges
    u, v, cost = inst.u, inst.v, inst.cost
    S = torch.zeros(E, dtype=torch.bool, device=u.device)
    free = inst.node_valid
    eidx = torch.arange(E, dtype=torch.int32, device=u.device)
    ul, vl = u.long(), v.long()
    for _ in range(rounds):
        active = inst.edge_valid & (cost > min_cost) & free[ul] & free[vl]
        best = _node_best_positive_edge(u, v, cost, active, N)
        sel = active & (best[ul] == eidx) & (best[vl] == eidx)
        S = S | sel
        s32 = sel.to(torch.int32)
        matched = _scatter_extreme(N, 0, ul, s32, "amax")
        matched = matched.scatter_reduce(0, vl, s32, "amax") > 0
        free = free & ~matched
    return S


def spanning_forest_contraction(inst: MulticutInstance, rounds: int = 4,
                                min_cost=0.0):
    """Borůvka-style maximum spanning forest on attractive edges with
    conflict freezing: a round that would place a repulsive edge inside a
    component is reverted for that component."""
    N, E = inst.num_nodes, inst.num_edges
    u, v, cost = inst.u, inst.v, inst.cost
    ul, vl = u.long(), v.long()
    dev = u.device
    neg = inst.edge_valid & (cost < 0)
    S = torch.zeros(E, dtype=torch.bool, device=dev)
    labels = torch.arange(N, dtype=torch.int32, device=dev)
    eidx = torch.arange(E, dtype=torch.int32, device=dev)
    for _ in range(rounds):
        cl_u, cl_v = labels[ul], labels[vl]
        active = inst.edge_valid & (cost > min_cost) & (cl_u != cl_v)
        # best outgoing edge per component (keyed by component root label)
        seg = torch.cat([cl_u, cl_v])
        val = torch.cat([cost, cost])
        msk = torch.cat([active, active])
        edge_of = torch.cat([eidx, eidx])
        arg, _ = segment_argmax(val, seg, N, mask=msk)
        best_edge = torch.where(arg >= 0, edge_of[arg.long().clamp(min=0)],
                                torch.full_like(arg, -1))
        cand = _scatter_extreme(E, 0, best_edge.clamp(min=0),
                                (best_edge >= 0).to(torch.int32), "amax") > 0
        cand = cand & active
        S_try = S | cand
        labels_try = connected_components(u, v, S_try, N, site="forest_try")
        lt_u, lt_v = labels_try[ul], labels_try[vl]
        # conflict: repulsive edge newly internal to a merged component
        conflict = neg & (lt_u == lt_v) & (labels[ul] != labels[vl])
        frozen = _scatter_extreme(N, 0, lt_u, conflict.to(torch.int32),
                                  "amax") > 0
        keep = cand & ~frozen[lt_u.long()] & ~frozen[lt_v.long()]
        S = S | keep
        labels = connected_components(u, v, S, N, site="forest_keep")
    return S


def choose_contraction_set(inst: MulticutInstance, matching_rounds: int = 3,
                           forest_rounds: int = 4, switch_frac: float = 0.1,
                           contract_frac: float = 0.0):
    """Paper §3.1: matching first; if it matched fewer than
    ``switch_frac * |V|`` edges, use the spanning forest instead (both are
    computed and selected on the device, no host sync). Never returns fewer
    edges than the matching found. ``contract_frac`` > 0 keeps only edges
    above that fraction of the round's maximum positive cost. The
    ``contraction.forest`` span's ``used`` says whether the forest's set
    was the one taken."""
    min_cost = 0.0
    if contract_frac > 0.0:
        cmax = torch.where(inst.edge_valid, inst.cost,
                           torch.zeros_like(inst.cost)).max()
        min_cost = contract_frac * cmax.clamp(min=0.0)
    S_match = maximum_matching(inst, rounds=matching_rounds,
                               min_cost=min_cost)
    n_nodes = inst.node_valid.sum()
    n_match = S_match.sum()
    enough = n_match >= switch_frac * n_nodes
    with obs.phase("contraction.forest") as forest:
        S_forest = spanning_forest_contraction(inst, rounds=forest_rounds,
                                               min_cost=min_cost)
    use_match = enough | (S_forest.sum() < n_match)
    if forest:
        forest.set(used=~use_match)
    return torch.where(use_match, S_match, S_forest)


# ---------------------------------------------------------------------------
# Contraction (Lemma 4)
# ---------------------------------------------------------------------------

class ContractionResult(NamedTuple):
    instance: MulticutInstance
    mapping: torch.Tensor         # (N,) old node -> new compact node id
    n_new: torch.Tensor           # scalar: number of live clusters
    self_loop_gain: torch.Tensor  # Lemma 4(b): total cost absorbed
    n_contracted: torch.Tensor    # edges contracted this round


def _fixed_order_run_sum(values, seg, is_entry, num_segments: int):
    """Sum ``values`` of the entries with ``is_entry`` into ``seg`` in
    array order, where ``seg`` is nondecreasing over those entries: the
    entries are compacted by a prefix sum (each segment then contiguous)
    and each segment is added one entry at a time from 0.0 — a fixed order
    with no sort and no atomics, the same on the CPU and the card, and
    equal to the reference's sequential segment_sum. One host sync (the
    longest segment, site ``run_sum_len``)."""
    n = values.shape[0]
    dest = torch.where(is_entry, torch.cumsum(is_entry.to(torch.int64), 0)
                       - 1, torch.full_like(seg, n, dtype=torch.int64))
    data = torch.zeros(n + 1, dtype=values.dtype, device=values.device) \
        .scatter_(0, dest, values)[:n]
    lengths = torch.zeros(num_segments + 1, dtype=torch.int64,
                          device=values.device)
    lengths.scatter_add_(0, torch.where(is_entry, seg.long(),
                                        torch.full_like(seg.long(),
                                                        num_segments)),
                         torch.ones_like(dest))
    lengths = lengths[:num_segments]
    starts = torch.cumsum(lengths, 0) - lengths
    max_len = 0
    if num_segments:
        max_len = int(lengths.max())
        obs.count_sync("run_sum_len", lengths.device)
    return sequential_sums(data, starts, lengths, max_len)


def _contract_core(inst: MulticutInstance, S: torch.Tensor):
    """Relabel endpoints by component, then one sort over the 2E directed
    edge copies that both merges parallel edges (sum costs, new edge ids in
    (lo, hi) order) and yields the contracted graph's CSR. Returns
    (ContractionResult, CsrGraph)."""
    N, E = inst.num_nodes, inst.num_edges
    dev = inst.u.device
    labels = connected_components(inst.u, inst.v, S & inst.edge_valid, N,
                                  site="merge")
    ar_n = torch.arange(N, dtype=torch.int32, device=dev)
    is_root = (labels == ar_n) & inst.node_valid
    new_id = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    f = new_id[labels.long()]
    f = torch.where(inst.node_valid, f, torch.zeros_like(f))
    n_new = is_root.sum()

    fu, fv = f[inst.u.long()], f[inst.v.long()]
    self_loop = inst.edge_valid & (fu == fv)
    gain = torch.where(self_loop, inst.cost,
                       torch.zeros_like(inst.cost)).sum()
    valid = inst.edge_valid & ~self_loop

    # the one sort: 2E directed copies by (src, dst, original edge id); dead
    # copies get sentinel endpoints that sort past every live row.
    # reference: jnp.lexsort((tile(eid0, 2), dst, src)) — chained stable
    # sorts (a packed (src, dst, eid) int64 key overflows at paper scale)
    eid0 = torch.arange(E, dtype=torch.int32, device=dev)
    m = torch.cat([valid, valid])
    sent = torch.full((2 * E,), N, dtype=torch.int32, device=dev)
    src = torch.where(m, torch.cat([fu, fv]), sent)
    dst = torch.where(m, torch.cat([fv, fu]), sent)
    order = lexsort((eid0.repeat(2), dst, src))
    s, d = src[order], dst[order]
    w_s = inst.cost.repeat(2)[order]
    live = m[order]
    nnz = 2 * E

    # runs of equal (src, dst) = unique directed pairs = CSR entries;
    # compacting run heads to their run rank keeps them sorted
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      (s[1:] != s[:-1]) | (d[1:] != d[:-1])])
    is_new = live & head
    rid = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    cpos = torch.where(is_new, rid, torch.full_like(rid, nnz)).long()
    cs = torch.full((nnz + 1,), N, dtype=torch.int32, device=dev) \
        .scatter_(0, cpos, s)[:nnz]
    cd = torch.full((nnz + 1,), N, dtype=torch.int32, device=dev) \
        .scatter_(0, cpos, d)[:nnz]
    row_ptr = torch.searchsorted(
        cs, torch.arange(N + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)

    # undirected edge ids: forward pairs (src < dst) appear in (lo, hi)
    # order, so their rank is the new edge id; each backward pair bisects
    # row ``dst`` for its forward partner's id
    fwd = cs < cd
    new_eid = torch.cumsum(fwd.to(torch.int32), 0, dtype=torch.int32) - 1
    n_unique = fwd.sum()
    minus1 = torch.full_like(new_eid, -1)
    probe = CsrGraph(row_ptr=row_ptr, col=cd,
                     edge_id=torch.where(fwd, new_eid, minus1))
    partner = csr_lookup_edge(probe, torch.where(cs < N, cd,
                                                 torch.zeros_like(cd)), cs)
    eid_c = torch.where(fwd, new_eid, partner)
    eid_c = torch.where(cs < N, eid_c, minus1).to(torch.int32)
    csr = CsrGraph(row_ptr=row_ptr, col=cd, edge_id=eid_c)

    # contracted COO: scatter run heads by new id, sum the costs of each
    # forward run in entry order (entries ascend by original edge id — the
    # sorts are stable), so the accumulation order is fixed
    fw_dest = torch.where(fwd, new_eid, torch.full_like(new_eid, E)).long()
    u2 = torch.zeros(E + 1, dtype=torch.int32, device=dev) \
        .scatter_(0, fw_dest, cs)[:E]
    v2 = torch.zeros(E + 1, dtype=torch.int32, device=dev) \
        .scatter_(0, fw_dest, cd)[:E]
    fw_entry = live & (s < d)
    seg = eid_c[rid.long().clamp(0, nnz - 1)]
    c2 = _fixed_order_run_sum(w_s, seg, fw_entry, E)
    ev2 = torch.arange(E, device=dev) < n_unique
    c2 = torch.where(ev2, c2, torch.zeros_like(c2))

    node_valid = torch.arange(N, device=dev) < n_new
    out = MulticutInstance(u=u2, v=v2, cost=c2, edge_valid=ev2,
                           node_valid=node_valid)
    res = ContractionResult(instance=out, mapping=f, n_new=n_new,
                            self_loop_gain=gain,
                            n_contracted=(S & inst.edge_valid).sum())
    return res, csr


def contract(inst: MulticutInstance, S: torch.Tensor) -> ContractionResult:
    """Contract edge set S: relabel endpoints by component, merge parallel
    edges by summing costs (Alg. 4's sort + reduce_by_key)."""
    return _contract_core(inst, S)[0]


def contract_csr(inst: MulticutInstance, S: torch.Tensor):
    """Contract edge set S and also return the contracted graph's
    :class:`CsrGraph`, maintained from the contraction's own sort (equal
    to a fresh ``build_csr``). The solver carries it to the next round."""
    return _contract_core(inst, S)


# ---------------------------------------------------------------------------
# Edge-range-sharded contraction (SolverConfig.state_shards)
#
# Each function runs on one rank of the state group: per-edge arrays are
# the rank's local (E/S,) contiguous range, per-node arrays are the same on
# every rank. Every output equals the replicated half's bit for bit for
# every shard count: min/max scatters combine across ranks with all_min/
# all_max of int32 tables (exact), argmax ties travel as integer keys of
# the replicated concat index (dist.combine_node_best), integer counts go
# through all_sum_int, and floats are summed either by dist.blocked_sum
# (scalars) or per destination in the replicated path's entry order
# (merged costs). Python branches read only values that a collective has
# made the same on every rank, so the ranks stay in lockstep.
# ---------------------------------------------------------------------------

def connected_components_sharded(u_loc, v_loc, edge_mask_loc, num_nodes: int,
                                 group, site: str = "other"):
    """Sharded :func:`connected_components`: each rank min-scatters its own
    edges, an all_min fuses the partial scatters (equal to the scatter over
    all edges), then the pointer jumping runs on the replicated labels.
    The label trajectory is the replicated loop's, so every rank takes
    the same convergence branch. ``site`` as in the replicated one."""
    ul, vl = u_loc.long(), v_loc.long()

    def step(labels):
        lu, lv = labels[ul], labels[vl]
        m = torch.minimum(lu, lv)
        new = labels.scatter_reduce(0, ul, torch.where(edge_mask_loc, m, lu),
                                    "amin", include_self=True)
        new = new.scatter_reduce(0, vl, torch.where(edge_mask_loc, m, lv),
                                 "amin", include_self=True)
        new = all_min(new, group)
        new = new[new.long()]           # pointer jumping (twice)
        return new[new.long()]

    labels = torch.arange(num_nodes, dtype=torch.int32, device=u_loc.device)
    return _propagate(labels, step, site)


def _node_best_edge_sharded(seg0, seg1, cost_loc, active_loc,
                            num_segments: int, shards: int, group):
    """Sharded :func:`_node_best_positive_edge` (segments: node ids for the
    matching, component labels for the forest). Returns the (N,) GLOBAL
    edge id each segment picks, or -1. The replicated argmax ties toward
    the smallest index of the 2E concat [u-copies, v-copies]; each rank's
    local winner is its smallest local index, whose global tie key is
    ``direction * E + global id``, so the fold by (max value, min key)
    picks the replicated winner."""
    E_loc = cost_loc.shape[0]
    E = E_loc * shards
    e0 = edge_range_start(E_loc, group)
    seg = torch.cat([seg0, seg1])
    val = torch.cat([cost_loc, cost_loc])
    msk = torch.cat([active_loc, active_loc])
    arg, vmax = segment_argmax(val, seg, num_segments, mask=msk)
    dir_ = (arg >= E_loc).to(torch.int32)
    lid = arg - dir_ * E_loc
    has = arg >= 0
    key = torch.where(has, dir_ * E + e0 + lid,
                      torch.full_like(arg, torch.iinfo(torch.int32).max))
    pay = torch.where(has, e0 + lid, torch.full_like(arg, -1))
    return combine_node_best(vmax, key, pay, group)[2]


def maximum_matching_sharded(u_loc, v_loc, cost_loc, ev_loc, node_valid,
                             rounds: int, min_cost, shards: int, group):
    """Sharded :func:`maximum_matching`; returns the rank's (E/S,) slice of
    the replicated matching."""
    N = node_valid.shape[0]
    E_loc = u_loc.shape[0]
    dev = u_loc.device
    geid = edge_range_start(E_loc, group) + torch.arange(
        E_loc, dtype=torch.int32, device=dev)
    ul, vl = u_loc.long(), v_loc.long()
    S = torch.zeros(E_loc, dtype=torch.bool, device=dev)
    free = node_valid
    for _ in range(rounds):
        active = ev_loc & (cost_loc > min_cost) & free[ul] & free[vl]
        best = _node_best_edge_sharded(u_loc, v_loc, cost_loc, active, N,
                                       shards, group)
        sel = active & (best[ul] == geid) & (best[vl] == geid)
        S = S | sel
        s32 = sel.to(torch.int32)
        m = _scatter_extreme(N, 0, ul, s32, "amax")
        m = m.scatter_reduce(0, vl, s32, "amax")
        free = free & ~(all_max(m, group) > 0)
    return S


def spanning_forest_sharded(u_loc, v_loc, cost_loc, ev_loc, node_valid,
                            rounds: int, min_cost, shards: int, group):
    """Sharded :func:`spanning_forest_contraction`; returns the rank's
    slice of the replicated forest (labels, freezing masks and best-edge
    picks are replicated-exact every round)."""
    N = node_valid.shape[0]
    E_loc = u_loc.shape[0]
    dev = u_loc.device
    e0 = edge_range_start(E_loc, group)
    ul, vl = u_loc.long(), v_loc.long()
    neg = ev_loc & (cost_loc < 0)
    S = torch.zeros(E_loc, dtype=torch.bool, device=dev)
    labels = torch.arange(N, dtype=torch.int32, device=dev)
    for _ in range(rounds):
        cl_u, cl_v = labels[ul], labels[vl]
        active = ev_loc & (cost_loc > min_cost) & (cl_u != cl_v)
        best_edge = _node_best_edge_sharded(cl_u, cl_v, cost_loc, active, N,
                                            shards, group)
        own = (best_edge >= e0) & (best_edge < e0 + E_loc)
        idx = torch.where(own, best_edge - e0, torch.full_like(best_edge,
                                                               E_loc))
        cand = _scatter_extreme(E_loc + 1, 0, idx, own.to(torch.int32),
                                "amax")[:E_loc] > 0
        cand = cand & active
        S_try = S | cand
        labels_try = connected_components_sharded(u_loc, v_loc, S_try, N,
                                                  group, site="forest_try")
        lt_u, lt_v = labels_try[ul], labels_try[vl]
        conflict = neg & (lt_u == lt_v) & (labels[ul] != labels[vl])
        fr = _scatter_extreme(N, 0, lt_u, conflict.to(torch.int32), "amax")
        frozen = all_max(fr, group) > 0
        keep = cand & ~frozen[lt_u.long()] & ~frozen[lt_v.long()]
        S = S | keep
        labels = connected_components_sharded(u_loc, v_loc, S, N, group,
                                              site="forest_keep")
    return S


def choose_contraction_set_sharded(u_loc, v_loc, cost_loc, ev_loc,
                                   node_valid, matching_rounds: int,
                                   forest_rounds: int, switch_frac: float,
                                   contract_frac: float, shards: int, group):
    """Sharded :func:`choose_contraction_set`. Edge counts cross ranks as
    exact integer sums and the cost ceiling as an all_max, so the
    matching/forest switch (a device-side select) decides as the
    replicated one does."""
    min_cost = 0.0
    if contract_frac > 0.0:
        cmax = all_max(torch.where(ev_loc, cost_loc,
                                   torch.zeros_like(cost_loc)).max(), group)
        min_cost = contract_frac * cmax.clamp(min=0.0)
    S_match = maximum_matching_sharded(u_loc, v_loc, cost_loc, ev_loc,
                                       node_valid, matching_rounds, min_cost,
                                       shards, group)
    n_match = all_sum_int(S_match.sum(), group)
    enough = n_match >= switch_frac * node_valid.sum()
    with obs.phase("contraction.forest") as forest:
        S_forest = spanning_forest_sharded(u_loc, v_loc, cost_loc, ev_loc,
                                           node_valid, forest_rounds,
                                           min_cost, shards, group)
    n_forest = all_sum_int(S_forest.sum(), group)
    use_match = enough | (n_forest < n_match)
    if forest:
        forest.set(used=~use_match)
    return torch.where(use_match, S_match, S_forest)


def _lex2_count_less(key_sorted, lo, hi, num_nodes: int):
    """Count of entries of the sorted pair keys strictly before each (lo,
    hi): one ``searchsorted`` on the int64 key ``lo·(N+1)+hi``, which
    orders pairs lexicographically (the reference's 2-key bisect)."""
    key = lo.long() * (num_nodes + 1) + hi.long()
    return torch.searchsorted(key_sorted, key, side="left")


class ShardedContraction(NamedTuple):
    """One rank's view of one contraction: per-edge leaves are its (E/S,)
    slice of the contracted instance (global new-edge range ``[rank *
    E/S, (rank+1) * E/S)``), per-node leaves replicated."""
    u2: torch.Tensor          # (E/S,) local contracted COO
    v2: torch.Tensor
    c2: torch.Tensor
    ev2: torch.Tensor
    node_valid: torch.Tensor  # (N,) replicated
    mapping: torch.Tensor     # (N,) old node -> new compact id
    n_new: torch.Tensor
    self_loop_gain: torch.Tensor
    n_contracted: torch.Tensor
    csr: CsrGraph             # the rank's CSR (LOCAL edge ids)


def contract_sharded(u_loc, v_loc, cost_loc, ev_loc, node_valid, S_loc,
                     shards: int, group) -> ShardedContraction:
    """Sharded :func:`_contract_core`, in two exchanges.

    Exchange 1 all_gathers every surviving edge's pair key ``lo·(N+1)+hi``
    (E int64, transient); one sort of it gives the global unique pair list
    on every rank, and a pair's rank in it is the replicated new edge id
    (forward runs are in (lo, hi) order there). Exchange 2 all_gathers
    each edge's (target id, cost) in global id order; each rank sums the
    entries of the targets it owns one at a time in that order — within a
    pair, ascending original edge id, as the replicated sort leaves them
    (its ties on (src, dst) are broken by edge id across both
    orientations) — so the merged costs equal the replicated path's bit
    for bit for every shard count. The reference's exchange takes the
    (fu < fv) entries before the (fu > fv) ones, which differs from its
    own replicated sum on a pair merged from three or more edges of both
    orientations; the port keeps the replicated order. One host sync (the
    longest merged run, site ``run_sum_len``)."""
    N = node_valid.shape[0]
    E_loc = u_loc.shape[0]
    dev = u_loc.device
    e0 = edge_range_start(E_loc, group)
    labels = connected_components_sharded(u_loc, v_loc, S_loc & ev_loc, N,
                                          group, site="merge")
    ar_n = torch.arange(N, dtype=torch.int32, device=dev)
    is_root = (labels == ar_n) & node_valid
    new_id = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    f = new_id[labels.long()]
    f = torch.where(node_valid, f, torch.zeros_like(f))
    n_new = is_root.sum()

    fu, fv = f[u_loc.long()], f[v_loc.long()]
    self_loop = ev_loc & (fu == fv)
    gain = blocked_sum(torch.where(self_loop, cost_loc,
                                   torch.zeros_like(cost_loc)), shards, group)
    valid2 = ev_loc & ~self_loop

    # exchange 1: the global unique (lo, hi) list, sentinel keys last
    sent = N * (N + 1) + N
    lo, hi = torch.minimum(fu, fv), torch.maximum(fu, fv)
    key = torch.where(valid2, lo.long() * (N + 1) + hi.long(),
                      torch.full_like(lo, sent, dtype=torch.int64))
    gs = torch.sort(all_gather(key, group).reshape(-1)).values     # (E,)
    E = gs.shape[0]
    head = torch.cat([gs[:1] < sent, (gs[1:] != gs[:-1]) & (gs[1:] < sent)])
    rank = torch.cumsum(head.to(torch.int64), 0) - 1
    n_unique = head.sum()
    uniq = torch.full((E + 1,), sent, dtype=torch.int64, device=dev) \
        .scatter_(0, torch.where(head, rank, E), gs)[:E]

    # new edge id of each surviving edge: the rank of its pair
    target = torch.where(valid2, _lex2_count_less(uniq, lo, hi, N),
                         torch.full_like(key, -1))

    # exchange 2: (target, cost) in global id order; each rank sums its
    # targets' entries in that order
    gt = all_gather(target, group).reshape(-1)
    gc = all_gather(cost_loc, group).reshape(-1)
    mine = (gt >= e0) & (gt < e0 + E_loc)
    seg = torch.where(mine, gt - e0, torch.full_like(gt, E_loc))
    perm = torch.sort(seg, stable=True).indices
    lengths = torch.zeros(E_loc + 1, dtype=torch.int64, device=dev) \
        .scatter_add_(0, seg, torch.ones_like(seg))[:E_loc]
    starts = torch.cumsum(lengths, 0) - lengths
    c2 = sequential_sums(gc[perm], starts, lengths, int(lengths.max()))
    obs.count_sync("run_sum_len", dev)

    idx = e0 + torch.arange(E_loc, dtype=torch.int64, device=dev)
    ev2 = idx < n_unique
    k2 = uniq[idx]
    zero = torch.zeros_like(k2)
    u2 = torch.where(ev2, k2 // (N + 1), zero).to(torch.int32)
    v2 = torch.where(ev2, k2 % (N + 1), zero).to(torch.int32)
    c2 = torch.where(ev2, c2, torch.zeros_like(c2))
    n_contracted = all_sum_int((S_loc & ev_loc).sum(), group)
    return ShardedContraction(
        u2=u2, v2=v2, c2=c2, ev2=ev2,
        node_valid=torch.arange(N, device=dev) < n_new, mapping=f,
        n_new=n_new, self_loop_gain=gain, n_contracted=n_contracted,
        csr=build_csr(u2, v2, ev2, N))


# ---------------------------------------------------------------------------
# Dense oracles (Lemma 4)
# ---------------------------------------------------------------------------

def adjacency_dense(inst: MulticutInstance) -> torch.Tensor:
    """Dense symmetric adjacency (Definition 2) — small-N / test path.

    Parallel edges add into one cell through ``index_put_(accumulate=True)``;
    on CUDA that sum runs in no fixed order, so its float outputs compare
    within a tolerance, not bitwise."""
    N = inst.num_nodes
    A = torch.zeros((N, N), dtype=inst.cost.dtype, device=inst.cost.device)
    c = torch.where(inst.edge_valid, inst.cost, torch.zeros_like(inst.cost))
    u, v = inst.u.long(), inst.v.long()
    A.index_put_((u, v), c, accumulate=True)
    A.index_put_((v, u), c, accumulate=True)
    return A


def contract_dense(A: torch.Tensor, f: torch.Tensor,
                   n_new: int) -> torch.Tensor:
    """Lemma 4(a): A' = KᵀAK − diag(KᵀAK) with K the one-hot contraction
    matrix, in plain torch (float32, TF32 off). Dense oracle for the
    ``contract_matmul`` kernel."""
    return contract_matmul_ref(A, f, n_new, drop_diag=True)
