"""Collectives, the edge-range state group and the block decomposition over
``torch.distributed`` (port of ``repro.core.dist``).

The reference is single-controller: one ``shard_map`` over a mesh of local
devices. The port is SPMD: every rank of a process group runs the same
Python loop on its own part, and the reference's ``all_gather``,
``pmin``, ``pmax``, ``psum`` and ``all_to_all`` become the collectives
below (NCCL on cards, gloo on the CPU). Every collective takes an
explicit group; ``None`` means no process group, a group of one, whose
collectives are identities.

*Edge-range state sharding* (``SolverConfig.state_shards``,
:mod:`repro_torch.core.sharded`): rank s of the state group owns the
contiguous range ``[s * E/S, (s+1) * E/S)`` of every per-edge array for
the life of a solve. Everything here serves shard-count invariance: a
float is never summed by a collective (NCCL's ring order depends on S),
so scalars go through :func:`blocked_sum`'s fixed ranges and per-edge
values through ownership gathers (all_gather + integer select).

*Block decomposition* (:func:`make_dist_pd_round`): nodes are cut into
contiguous blocks (:func:`partition_instance`, host numpy); each rank runs
one PD round on each of its blocks; the block bounds plus
Σ min(0, c_boundary) give a valid global lower bound (dropping the
boundary constraints only relaxes the problem); the quotient of the
contracted blocks and the boundary edges (:func:`merge_blocks_quotient`)
is small enough for one card.

*Separation and batch sharding* (``separation_shards``, ``batch_shards``)
use no ranks: one process spreads one step of a replicated solve (the
repulsive-edge batch of separation, or the slots of a batch) over the
devices :func:`shard_devices` names, shard r on ``cuda:r``, and gathers
the results back on the instance's device. Integers are gathered and no
float is summed across shards, so the output does not depend on S.

*Collective bytes*: inside :func:`count_collective_bytes` every
collective below adds the bytes this rank contributes to it (numel ×
element size of its operand; for :func:`broadcast`, the source rank's
tensor) when its group has more than one rank. A group of one sends
nothing; gloo's copies of CUDA tensors through host memory are not
counted.
"""
from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.graph import MulticutInstance, make_instance, \
    to_host_edges

__all__ = [
    "STATE_AXIS", "STATE_BLOCKS", "all_gather", "all_max", "all_min",
    "all_sum_int", "all_to_all", "blocked_sum", "broadcast",
    "combine_node_best", "edge_range_start", "gather_edge_field",
    "group_rank", "group_size",
    "local_pd_round", "make_dist_pd_round", "merge_blocks_quotient",
    "count_collective_bytes", "partition_instance", "resolve_batch_shards",
    "resolve_separation_shards", "resolve_state_shards", "shard_devices",
    "state_group", "tree_sum",
]

STATE_AXIS = "state"

# Fixed number of reduction ranges for S-invariant scalar sums over the
# edge axis: the padded edge count is split into STATE_BLOCKS contiguous
# ranges, each summed locally, and the (STATE_BLOCKS,) partials are
# combined in the same fixed order on every rank, so any S dividing
# STATE_BLOCKS computes the identical float result.
STATE_BLOCKS = 16


# ---------------------------------------------------------------------------
# Groups and collectives
# ---------------------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _through_host(x: torch.Tensor, group) -> bool:
    """Gloo has no collectives of CUDA tensors: they go through host
    memory, chosen by the group's backend."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective sends: bool as uint8, CUDA through host
    memory on gloo (a copy that waits for the device: site
    ``collective_to_host`` of the solve path's sync counter), contiguous."""
    if x.dtype is torch.bool:
        x = x.to(torch.uint8)
    if _through_host(x, group):
        obs.count_sync("collective_to_host", x.device)
        x = x.cpu()
    return x.contiguous()


_COUNTERS: list[dict] = []     # the open count_collective_bytes records


@contextlib.contextmanager
def count_collective_bytes():
    """Count what this rank's collectives send while the ``with`` body
    runs: yields a dict whose ``bytes`` and ``calls`` grow with every
    collective over a group of more than one rank."""
    rec = {"bytes": 0, "calls": 0}
    _COUNTERS.append(rec)
    try:
        yield rec
    finally:
        _COUNTERS.remove(rec)


def _count_sent(x: torch.Tensor, group) -> None:
    if _COUNTERS and group_size(group) > 1:
        n = x.numel() * x.element_size()
        for rec in _COUNTERS:
            rec["bytes"] += n
            rec["calls"] += 1


def _unwire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The collective's result as ``like``: back from host memory a copy
    that waits for the device (site ``collective_from_host``)."""
    if y.device != like.device:
        obs.count_sync("collective_from_host", like.device)
    return y.to(device=like.device, dtype=like.dtype)


_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ``(S, *x.shape)`` stack of every rank's ``x``, in rank order;
    exact for every dtype (no arithmetic)."""
    if group is None:
        return x.unsqueeze(0)
    S = group_size(group)
    _count_sent(x, group)
    w = _wire(x.reshape((1,) + tuple(x.shape)), group)
    out = torch.empty((S * w.shape[0],) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    _gather_single(out, w, group=group)
    return _unwire(out, x)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if group is None:
        return x
    _count_sent(x, group)
    w = _wire(x.reshape(-1), group)
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    dist.all_reduce(w, op=op, group=group)
    return _unwire(w, x).reshape(x.shape)


def all_min(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise min over the group's ranks (exact for any dtype)."""
    return _all_reduce(x, group, dist.ReduceOp.MIN)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group's ranks (exact for any dtype)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def all_sum_int(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum over the group's ranks of an integer tensor. A float
    is never summed by a collective (its order depends on S): use
    :func:`blocked_sum`."""
    if x.dtype.is_floating_point:
        raise TypeError("all_sum_int: floats go through blocked_sum, whose "
                        "order does not depend on the shard count")
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Exchange rows: ``x`` is ``(S, ...)``, row p goes to rank p of the
    group, and row r of the result is what rank r sent this rank (the
    reference's ``all_to_all(split_axis=0, concat_axis=0, tiled=False)``);
    exact for every dtype (no arithmetic)."""
    if group is None:
        return x
    S = group_size(group)
    if x.shape[0] != S:
        raise ValueError(f"all_to_all: {x.shape[0]} rows for a group of "
                         f"{S} ranks")
    _count_sent(x, group)
    w = _wire(x, group)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return _unwire(out, x)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of ``group``; returns the
    received tensor."""
    if group is None:
        return x
    if dist.get_rank() == src:
        _count_sent(x, group)
    w = _wire(x.reshape(-1), group)
    w = w.clone() if w.data_ptr() == x.data_ptr() else w
    dist.broadcast(w, src=src, group=group)
    return _unwire(w, x).reshape(x.shape)


# ---------------------------------------------------------------------------
# The edge-range state group
# ---------------------------------------------------------------------------

# Subgroups made by ``state_group``, by count, under "world" the default
# group they were made from. Groups are held by weak reference, so the
# cache keeps none alive after ``destroy_process_group``: a gloo group's
# worker threads are joined only when the group object is freed (see
# ``repro_torch.launch.ranks``). A rank outside a subgroup keeps the
# ``NON_GROUP_MEMBER`` sentinel, so it never calls ``new_group`` twice.
_STATE_GROUPS: dict = {}


def _cached_group(key):
    entry = _STATE_GROUPS.get(key)
    return entry() if isinstance(entry, weakref.ref) else entry


def resolve_state_shards(shards: int | None) -> int:
    """Clamp a requested state-shard count to the ranks of the default
    process group (1 without one) and to a divisor of STATE_BLOCKS, as the
    reference clamps to the devices present."""
    if shards is None or shards <= 1:
        return 1
    s = min(int(shards), _world_size())
    while STATE_BLOCKS % s:
        s -= 1
    return s


def state_group(shards: int):
    """The process group of ranks ``0 .. shards-1`` the edge-range state
    lives on (the port's ``state_mesh``): ``None`` without a process group
    (then ``shards`` must be 1), the default group when ``shards`` is its
    size, else a subgroup made once per count by every rank and cached.
    Ranks outside it get ``GroupMember.NON_GROUP_MEMBER``."""
    if not dist.is_initialized():
        if shards != 1:
            raise ValueError(f"state_shards={shards} needs a process group "
                             f"of at least {shards} ranks; none is "
                             f"initialised")
        return None
    world = dist.get_world_size()
    if shards > world:
        raise ValueError(f"state_shards={shards} exceeds the {world} "
                         f"rank(s) of the default process group")
    if shards == world:
        return dist.group.WORLD
    if _cached_group("world") is not dist.group.WORLD:
        _STATE_GROUPS.clear()       # a new default group drops the old
        _STATE_GROUPS["world"] = weakref.ref(dist.group.WORLD)
    group = _cached_group(shards)
    if group is None:
        group = dist.new_group(ranks=list(range(shards)))
        _STATE_GROUPS[shards] = group \
            if group is dist.GroupMember.NON_GROUP_MEMBER \
            else weakref.ref(group)
    return group


def resolve_batch_shards(shards: int | None) -> int:
    """Clamp a requested batch- or separation-shard count to the CUDA
    devices present (1 on a host without one), so a router or the
    ``pd-sharded`` preset asking for 4 still runs on one card (the
    reference clamps to ``jax.device_count()``)."""
    if shards is None or shards <= 1:
        return 1
    return min(int(shards), max(1, torch.cuda.device_count()))


# the reference's name for the same clamp (``repro.core.cycles``)
resolve_separation_shards = resolve_batch_shards


def shard_devices(shards: int, device) -> list[torch.device]:
    """The device of each of ``shards`` shards of work whose inputs lie on
    ``device``: ``cuda:0 .. cuda:S-1`` for a CUDA instance, the CPU S
    times for a CPU one, and ``device`` itself for one shard. Raises when
    a shard's card is missing: nothing falls back to fewer shards."""
    device = torch.device(device)
    if device.type != "cuda" or shards == 1:
        return [device] * shards
    n = torch.cuda.device_count()
    if shards > n:
        raise ValueError(f"{shards} shards need {shards} CUDA devices; "
                         f"{n} present")
    return [torch.device("cuda", r) for r in range(shards)]


def edge_range_start(num_local_edges: int, group) -> int:
    """Global edge id of this rank's first slot."""
    return group_rank(group) * num_local_edges


def gather_edge_field(x_local: torch.Tensor, ids: torch.Tensor, group,
                      fill=0) -> torch.Tensor:
    """Ownership halo gather: the value of a sharded per-edge field at
    arbitrary *global* edge ids, the same on every rank. Each rank
    contributes its owned values (``fill`` elsewhere); one all_gather and
    an integer owner select recover the stored bits, with no float
    arithmetic."""
    E_loc = x_local.shape[0]
    e0 = edge_range_start(E_loc, group)
    ids = ids.long()
    local = ids - e0
    mine = (local >= 0) & (local < E_loc)
    vals = torch.where(mine, x_local[local.clamp(0, E_loc - 1)],
                       torch.full((), fill, dtype=x_local.dtype,
                                  device=x_local.device))
    gathered = all_gather(vals, group)                  # (S, ...) halo
    owner = (ids // E_loc).clamp(0, gathered.shape[0] - 1)
    return torch.gather(gathered, 0, owner.unsqueeze(0)).squeeze(0)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum along the LAST axis by an explicit pairwise halving tree of
    elementwise adds: the float DAG depends on the width alone, so the
    same width gives the same bits on every device, and the reference's
    ``tree_sum`` at that width."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        paired = x[..., : 2 * half: 2] + x[..., 1: 2 * half: 2]
        if x.shape[-1] % 2:
            paired = torch.cat([paired, x[..., -1:]], dim=-1)
        x = paired
    return x[..., 0]


def blocked_sum(x_local: torch.Tensor, shards: int, group,
                blocks: int = STATE_BLOCKS) -> torch.Tensor:
    """Shard-count-invariant sum of a sharded (E/S,) float array: each rank
    tree-sums its ``blocks/S`` fixed ranges, the (blocks,) partials are
    all_gathered in rank order (= ascending range order) and tree-summed
    the same way on every rank."""
    parts = tree_sum(x_local.reshape(blocks // shards, -1))
    return tree_sum(all_gather(parts, group).reshape(-1))


def combine_node_best(val_local, key_local, payload_local, group):
    """Combine per-rank (value, tie-key, payload) node tables into the
    global per-node argmax (max value; ties to the smallest key): a
    compare-and-select fold over the all_gathered tables in rank order,
    exact and the same for every shard count."""
    vals = all_gather(val_local, group)
    keys = all_gather(key_local, group)
    pays = all_gather(payload_local, group)
    bv, bk, bp = vals[0], keys[0], pays[0]
    for s in range(1, vals.shape[0]):
        better = (vals[s] > bv) | ((vals[s] == bv) & (keys[s] < bk))
        bv = torch.where(better, vals[s], bv)
        bk = torch.where(better, keys[s], bk)
        bp = torch.where(better, pays[s], bp)
    return bv, bk, bp


# ---------------------------------------------------------------------------
# Block decomposition
# ---------------------------------------------------------------------------

def local_pd_round(u, v, cost, edge_valid, node_valid, *, mp_iters: int,
                   max_neg: int, max_tri_per_edge: int, mp=None,
                   intersect=None):
    """One PD round on a single block (the solver's ``fused_pd_round``
    without 4/5-cycles). Returns (u', v', cost', edge_valid', node_valid',
    mapping, lb)."""
    from repro_torch.core.solver import SolverConfig, fused_pd_round
    inst = MulticutInstance(u=u, v=v, cost=cost, edge_valid=edge_valid,
                            node_valid=node_valid)
    cfg = SolverConfig(mp_iters=mp_iters, max_neg=max_neg,
                       max_tri_per_edge=max_tri_per_edge)
    res, lb = fused_pd_round(inst, cfg, with45=False, mp=mp,
                             intersect=intersect)
    out = res.instance
    return (out.u, out.v, out.cost, out.edge_valid, out.node_valid,
            res.mapping, lb)


def make_dist_pd_round(group=None, *, mp_iters: int = 3, max_neg: int = 128,
                       max_tri_per_edge: int = 4, backend: str = "cuda"):
    """The distributed PD round over ``group`` (``None``: no process group,
    one rank holds every block).

    ``dist_round(u, v, cost, edge_valid, node_valid, boundary_cost)`` takes
    the global arrays, u/v/cost/edge_valid (n_blocks, E_blk), node_valid
    (n_blocks, N_blk) and boundary_cost (B,), the same on every rank. Rank
    r runs :func:`local_pd_round` on blocks ``r * n_blocks/world`` up to
    the next rank's first, one after another; the outputs are all_gathered
    back into block order, so every rank returns the reference's global
    (contracted blocks..., mapping, lb). The bound is the per-block bounds
    added in block order by :func:`tree_sum` plus ``tree_sum(min(0,
    boundary_cost))``, not a collective sum: the same bits for every world
    size, within float rounding of the reference's ``psum``."""
    from repro_torch.core.solver import resolve_intersect, resolve_mp
    mp = resolve_mp(backend)
    intersect = resolve_intersect(backend)

    def dist_round(u, v, cost, edge_valid, node_valid, boundary_cost):
        world, rank = group_size(group), group_rank(group)
        n_blocks = u.shape[0]
        if n_blocks % world:
            raise ValueError(f"{n_blocks} blocks do not split over "
                             f"{world} rank(s)")
        per = n_blocks // world
        outs = [local_pd_round(u[b], v[b], cost[b], edge_valid[b],
                               node_valid[b], mp_iters=mp_iters,
                               max_neg=max_neg,
                               max_tri_per_edge=max_tri_per_edge, mp=mp,
                               intersect=intersect)
                for b in range(rank * per, (rank + 1) * per)]
        leaves = [all_gather(torch.stack(xs), group).flatten(0, 1)
                  for xs in zip(*outs)]
        lb_blocks = leaves.pop()
        bc = boundary_cost
        lb = tree_sum(lb_blocks) + tree_sum(
            torch.clamp(bc, max=0.0) if bc.numel()
            else torch.zeros(1, dtype=bc.dtype, device=bc.device))
        return (*leaves, lb)

    return dist_round


def partition_instance(inst: MulticutInstance, n_blocks: int,
                       blk_nodes: int, blk_edges: int) -> dict:
    """Host-side partitioner: contiguous node ranges → per-block padded COO
    plus the boundary edge list, as numpy arrays shaped for
    :func:`make_dist_pd_round` (the reference's numpy, line for line)."""
    u, v, c = to_host_edges(inst)
    N = inst.num_nodes
    block_of = np.minimum(np.arange(N) // blk_nodes, n_blocks - 1)
    bu, bv = block_of[u], block_of[v]
    interior = bu == bv
    out = {
        "u": np.zeros((n_blocks, blk_edges), np.int32),
        "v": np.zeros((n_blocks, blk_edges), np.int32),
        "cost": np.zeros((n_blocks, blk_edges), np.float32),
        "edge_valid": np.zeros((n_blocks, blk_edges), bool),
        "node_valid": np.zeros((n_blocks, blk_nodes), bool),
    }
    for b in range(n_blocks):
        sel = interior & (bu == b)
        uu = u[sel] - b * blk_nodes
        vv = v[sel] - b * blk_nodes
        cc = c[sel]
        k = min(len(uu), blk_edges)
        out["u"][b, :k] = uu[:k]
        out["v"][b, :k] = vv[:k]
        out["cost"][b, :k] = cc[:k]
        out["edge_valid"][b, :k] = True
        n_in_block = min(blk_nodes, max(N - b * blk_nodes, 0))
        out["node_valid"][b, :n_in_block] = True
    out["boundary_cost"] = c[~interior].astype(np.float32)
    out["boundary_u"] = u[~interior].astype(np.int32)
    out["boundary_v"] = v[~interior].astype(np.int32)
    return out


def merge_blocks_quotient(block_labels, boundary_u, boundary_v,
                          boundary_cost, blk_nodes: int, pad_edges: int,
                          device=None):
    """The quotient multicut instance over the contracted block clusters
    and the boundary edges, on ``device`` (default ``cuda``), and the
    global cluster id of every block node (host numpy, the reference's)."""
    block_labels = np.asarray(block_labels)
    n_blocks, N_blk = block_labels.shape
    # global cluster id = block * N_blk + local label, densified
    flat = (np.arange(n_blocks)[:, None] * N_blk
            + block_labels).reshape(-1)
    uniq, dense = np.unique(flat, return_inverse=True)
    gl = dense.reshape(n_blocks * N_blk)
    boundary_u = np.asarray(boundary_u)
    boundary_v = np.asarray(boundary_v)
    qu = gl[boundary_u // blk_nodes * N_blk + boundary_u % blk_nodes]
    qv = gl[boundary_v // blk_nodes * N_blk + boundary_v % blk_nodes]
    keep = qu != qv
    return make_instance(qu[keep], qv[keep],
                         np.asarray(boundary_cost)[keep],
                         num_nodes=len(uniq), pad_edges=pad_edges,
                         device=device), gl
