"""Owner-partitioned GNN message passing over ``torch.distributed`` (port
of ``repro.models.gnn.partitioned``).

Full-graph triplet message passing that replicates the edge-message
tensor on every device does not fit a large graph (one 512-wide float32
edge tensor of ``ogb_products`` is ~127 GB). The formulation here keeps
every tensor at O(E/D + halo) on each of D ranks:

  * the HOST partitioner (:func:`build_plan`) assigns every edge to the
    shard that owns its block of edge ids and every triplet (k→j, j→i)
    to the shard owning edge j→i, then fixes a HALO EXCHANGE plan:
    per-shard send lists (local edge slots each peer needs) and the
    local+halo index space the triplet gathers read from;
  * on the device, one block (:func:`make_triplet_block`) is: gather the
    send buffer → one capped ``all_to_all`` → concat local‖halo →
    triplet gather/compute → scatter-sum into LOCAL edges only.

The reference runs the block under ``shard_map``; the port is SPMD, as
``repro_torch.core.dist`` is: every rank of the group calls the block on
its own rows.
"""
from __future__ import annotations

import math
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import dist as dist_mod
from repro_torch.core.graph import resolve_device
from repro_torch.sparse.segment_ops import scatter_sum

__all__ = ["PartitionedTriplets", "abstract_plan", "build_plan",
           "dense_triplet_block", "make_triplet_block", "shard_group"]


class PartitionedTriplets(NamedTuple):
    """The halo plan of D shards (leading dim = shard); every rank holds
    all of it and reads its own row."""
    send_idx: torch.Tensor   # (D, D, H) int32: slots shard d sends peer p
    send_mask: torch.Tensor  # (D, D, H) bool
    tri_kj: torch.Tensor     # (D, T_l) int32: into [local ‖ halo] edges
    tri_ji: torch.Tensor     # (D, T_l) int32: into LOCAL edges
    tri_mask: torch.Tensor   # (D, T_l) bool
    e_local: int             # local edge count (padded, per shard)
    halo: int                # D * H — halo buffer length


def _position_in_group(group: np.ndarray) -> np.ndarray:
    """For each entry, how many entries of its group come before it."""
    order = np.argsort(group, kind="stable")
    sg = group[order]
    pos = np.empty(len(group), np.int64)
    pos[order] = np.arange(len(group)) - np.searchsorted(sg, sg)
    return pos


def build_plan(tri_kj: np.ndarray, tri_ji: np.ndarray, tri_mask: np.ndarray,
               n_edges: int, n_shards: int, halo_per_peer: int,
               tri_per_shard: int, device=None) -> PartitionedTriplets:
    """Host-side partitioner, on ``device`` (default ``cuda``). Edges are
    block-partitioned (edge e lives on shard e // e_local). Triplets go
    to the owner of their receiving edge tri_ji; tri_kj references either
    a local slot or a halo slot.

    The reference walks the triplets one by one; this computes the same
    arrays with whole-array numpy, and they are identical for every
    input. Walking the valid triplets in order, shard d keeps a triplet
    while it holds fewer than ``tri_per_shard``; a remote edge takes the
    next free halo slot of its (source, d) pair the first time shard d
    reads it, and a triplet whose edge finds the pair's ``halo_per_peer``
    slots taken is dropped. So per pair the first ``H`` distinct remote
    edges, in order of first reading, are the admissible ones; each
    shard keeps its first ``tri_per_shard`` admissible triplets; and a
    halo slot is filled iff the triplet that first read its edge was
    kept (a shard that is full reads nothing more)."""
    D, H, T_l = n_shards, halo_per_peer, tri_per_shard
    if n_edges % n_shards:
        raise ValueError(f"{n_edges} edges do not split into {n_shards} "
                         f"shards")
    e_local = n_edges // n_shards
    tri_kj = np.asarray(tri_kj).astype(np.int64)
    tri_ji = np.asarray(tri_ji).astype(np.int64)
    valid = np.flatnonzero(np.asarray(tri_mask, bool))
    kj, ji = tri_kj[valid], tri_ji[valid]
    for name, ids in (("tri_kj", kj), ("tri_ji", ji)):
        if ids.size and (ids.min() < 0 or ids.max() >= n_edges):
            raise ValueError(f"{name} holds an edge id outside "
                             f"[0, {n_edges})")
    d, src = ji // e_local, kj // e_local
    remote = src != d
    # each (shard, edge) pair read: its distinct edges ranked per (shard,
    # source) in order of first reading; a remote one's rank is its slot
    _, first, inv = np.unique(d * n_edges + kj, return_index=True,
                              return_inverse=True)
    by_first = np.argsort(first)
    rank = np.empty(len(first), np.int64)
    rank[by_first] = _position_in_group((d * D + src)[first[by_first]])
    slot = rank[inv]
    admissible = ~remote | (slot < H)

    pos = np.full(len(valid), T_l, np.int64)
    pos[admissible] = _position_in_group(d[admissible])
    kept = pos < T_l

    t_kj = np.zeros((D, T_l), np.int32)
    t_ji = np.zeros((D, T_l), np.int32)
    t_mask = np.zeros((D, T_l), bool)
    dk, pk = d[kept], pos[kept]
    t_ji[dk, pk] = ji[kept] - dk * e_local
    t_kj[dk, pk] = np.where(remote[kept],
                            e_local + src[kept] * H + slot[kept],
                            kj[kept] - dk * e_local)
    t_mask[dk, pk] = True

    # a remote edge's first reading by a shard fills its slot when that
    # triplet was kept
    fills = remote & kept & (first[inv] == np.arange(len(valid)))
    send_idx = np.zeros((D, D, H), np.int32)
    send_mask = np.zeros((D, D, H), bool)
    sf, df, hf = src[fills], d[fills], slot[fills]
    send_idx[sf, df, hf] = kj[fills] - sf * e_local
    send_mask[sf, df, hf] = True

    dev = resolve_device(device)
    return PartitionedTriplets(
        send_idx=torch.from_numpy(send_idx).to(dev),
        send_mask=torch.from_numpy(send_mask).to(dev),
        tri_kj=torch.from_numpy(t_kj).to(dev),
        tri_ji=torch.from_numpy(t_ji).to(dev),
        tri_mask=torch.from_numpy(t_mask).to(dev),
        e_local=e_local, halo=D * H)


def abstract_plan(n_edges: int, n_shards: int, halo_per_peer: int,
                  tri_per_shard: int) -> PartitionedTriplets:
    """A plan of ``meta`` tensors with the shapes and dtypes of
    :func:`build_plan`'s (no host partitioning)."""
    D, H, T = n_shards, halo_per_peer, tri_per_shard

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    return PartitionedTriplets(
        send_idx=meta((D, D, H), torch.int32),
        send_mask=meta((D, D, H), torch.bool),
        tri_kj=meta((D, T), torch.int32), tri_ji=meta((D, T), torch.int32),
        tri_mask=meta((D, T), torch.bool),
        e_local=n_edges // n_shards, halo=D * H)


def shard_group(mesh, axes=("data", "model")):
    """The process group over the ``axes`` of ``mesh`` that holds this
    rank, and this rank's shard index in it: its row-major coordinate
    on those axes, in the order given (the reference's
    ``P(("data", "model"))`` block order). ``(None, 0)`` for
    ``mesh=None``. Every rank of the mesh must call it (a subgroup is
    made by all ranks together)."""
    if mesh is None:
        return None, 0
    names = [a for a in axes if a in mesh.mesh_dim_names]
    if not names:
        raise ValueError(f"none of the axes {axes} is on the mesh "
                         f"{mesh.mesh_dim_names}")
    dims = [mesh.mesh_dim_names.index(a) for a in names]
    rest = [i for i in range(mesh.mesh.ndim) if i not in dims]
    rows = mesh.mesh.permute(rest + dims).reshape(
        -1, math.prod(mesh.mesh.shape[i] for i in dims)).tolist()
    me = dist.get_rank()
    if rows == [list(range(dist.get_world_size()))]:
        return dist.group.WORLD, me
    mine = None
    for row in rows:
        g = dist.new_group(ranks=row)
        if me in row:
            mine = (g, row.index(me))
    return mine


def dense_triplet_block(m: torch.Tensor, tri_kj: torch.Tensor,
                        tri_ji: torch.Tensor, tri_mask: torch.Tensor,
                        w: dict) -> torch.Tensor:
    """What one block computes on the whole (E, d) graph at once, with
    global edge ids: the one-device formulation the partitioned block is
    held against."""
    msg = F.silu(m.index_select(0, tri_kj.long()) @ w["w_tri"].to(m.dtype))
    msg = msg * tri_mask[:, None].to(msg.dtype)
    agg = scatter_sum(msg, tri_ji, m.shape[0])
    return m + F.silu(agg @ w["w_upd"].to(agg.dtype))


def make_triplet_block(mesh=None, axes=("data", "model")):
    """Returns ``block(m, plan, w) -> new m``, one triplet
    message-passing block over the group of ``mesh``'s ``axes``
    (:func:`shard_group`; every rank of the mesh makes its block).

    m: this rank's (e_local, d) edge messages, the rows of its shard;
       with ``mesh=None`` (or a group of one rank) the whole (E, d).
    w: the reference's dict of small replicated block weights:
       w_tri (d, d), w_upd (d, d) — the DimeNet-style bilinear stage is
       abstracted to one dense triplet transform; the point of this module
       is the data movement, which is identical.

    The block holds its group weakly: it raises once the group is
    destroyed, and keeps no group alive past
    :func:`repro_torch.launch.ranks.process_group`."""
    group, shard = shard_group(mesh, axes)
    ref = None if group is None else weakref.ref(group)

    def block(m: torch.Tensor, plan: PartitionedTriplets,
              w: dict) -> torch.Tensor:
        grp = None if ref is None else ref()
        if ref is not None and grp is None:
            raise RuntimeError("the block's process group was destroyed")
        D, _, H = plan.send_idx.shape
        if D != dist_mod.group_size(grp):
            raise ValueError(f"a plan of {D} shards on a group of "
                             f"{dist_mod.group_size(grp)} rank(s)")
        if m.shape[0] != plan.e_local:
            raise ValueError(f"{m.shape[0]} rows; the plan's shards hold "
                             f"{plan.e_local}")
        d = m.shape[-1]
        # 1. gather what peers need and exchange (capped all-to-all)
        send = m.index_select(0, plan.send_idx[shard].reshape(-1).long())
        send = send.reshape(D, H, d) \
            * plan.send_mask[shard][..., None].to(m.dtype)
        halo = dist_mod.all_to_all(send, grp).reshape(D * H, d)
        # 2. local + halo edge space
        m_ext = torch.cat([m, halo], dim=0)
        # 3. triplet compute (gather -> transform -> mask)
        x_kj = m_ext.index_select(0, plan.tri_kj[shard].long())
        msg = F.silu(x_kj @ w["w_tri"].to(x_kj.dtype))
        msg = msg * plan.tri_mask[shard][:, None].to(msg.dtype)
        # 4. scatter into local edges (tri_ji local by construction)
        agg = scatter_sum(msg, plan.tri_ji[shard], m.shape[0])
        return m + F.silu(agg @ w["w_upd"].to(agg.dtype))

    return block
