"""Shared GNN substrate (port of ``repro.models.gnn.common``): padded graph
batches, MLP blocks, topology builders.

All models consume fixed-shape ``GraphBatch``es (padded edge lists +
masks), the same static-shape discipline as the multicut core. Messages
are gathered with ``index_select`` and aggregated with
:func:`repro_torch.sparse.segment_ops.scatter_sum` (``index_add``: on CUDA
its order is not fixed; GNN aggregation feeds no discrete decision, so
the port is held against the reference within a tolerance).

Differences from the JAX module:

- Params are drawn from a ``torch.Generator``; the structure and the
  distributions are the reference's, the bits are not (tests carry the
  reference's params over with ``repro_torch.convert``).
- ``random_graph_batch`` and ``molecule_batch`` draw from a CPU
  ``torch.Generator`` (the same batch on every device) and put the batch
  on ``device``.
- ``layer_remat`` is ``torch.utils.checkpoint`` (non-reentrant): the
  backward holds one layer's working set, as ``jax.checkpoint`` does.
- Graph-partition data parallelism on a mesh: ``set_act_axes`` names
  the mesh axes that split node and edge hidden states along their
  leading dim, and the models call ``constrain`` on them at layer
  boundaries (``jax.lax.with_sharding_constraint`` there, a DTensor
  redistribute to ``Shard(0)`` here; without it the 2.4M x 512 node
  matrix of ogb_products would be whole on every rank). On DTensors
  :func:`take` and :func:`segment_sum_masked` run under ``local_map``:
  a gather reads the whole (all-gathered) source at each rank's own
  indices, a scatter sums each rank's own messages into a whole-size
  partial result that ``constrain`` reduce-scatters. Plain tensors pass
  through all of them untouched.
- ``jax.lax.scan`` over stacked layers becomes a Python loop over the
  layer list in every model.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.core.graph import resolve_device
from repro_torch.sharding import P, constrain as sh_constrain, is_dtensor, \
    placements, run_local
from repro_torch.sparse.segment_ops import scatter_sum
from repro_torch.tree import tree_map


class GraphBatch(NamedTuple):
    nodes: torch.Tensor        # (N, F) node features
    edges_src: torch.Tensor    # (E,) int32
    edges_dst: torch.Tensor    # (E,) int32
    edge_feat: torch.Tensor    # (E, Fe) edge features (zeros if unused)
    node_mask: torch.Tensor    # (N,) bool
    edge_mask: torch.Tensor    # (E,) bool
    graph_ids: torch.Tensor    # (N,) int32 graph id per node
    n_graphs: int = 1
    positions: torch.Tensor | None = None   # (N, 3) for molecular models
    labels: torch.Tensor | None = None      # task labels (node or graph)


def mlp_init(gen: torch.Generator, dims, scale=None) -> dict:
    """{"w": [(a, b) normal * scale (default 1/sqrt(a))], "b": [zeros]},
    float32 on ``gen``'s device."""
    ws, bs = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        s = scale or (1.0 / math.sqrt(a))
        ws.append(torch.randn((a, b), generator=gen,
                              device=gen.device).mul_(s))
        bs.append(torch.zeros((b,), device=gen.device))
    return {"w": ws, "b": bs}


def mlp_apply(p, x, act=F.silu, final_act=False):
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def layer_norm(x, eps=1e-6):
    """Normalise the last axis, no affine: (x - mean) / sqrt(var + eps)."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def layer_remat(fn):
    """``fn`` recomputed in the backward instead of keeping its
    activations (``jax.checkpoint``)."""
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return run


# ---------------------------------------------------------------------------
# Activation sharding (graph-partition data parallelism on a mesh)
# ---------------------------------------------------------------------------

_ACT_AXES = None


def set_act_axes(axes):
    """The mesh axes that split hidden states' leading dim (None: off);
    read by :func:`constrain` at trace time, as the reference's switch."""
    global _ACT_AXES
    _ACT_AXES = tuple(axes) if axes is not None else None


def constrain(x):
    """A DTensor x redistributed to its leading dim over the active axes
    (``set_act_axes``); anything else unchanged."""
    if _ACT_AXES is None or x is None or not is_dtensor(x):
        return x
    return sh_constrain(x, P(_ACT_AXES, *([None] * (x.dim() - 1))))


def constrain_tree(t):
    return tree_map(constrain, t)


def take(x, idx):
    """Rows ``x[idx]`` (ids in range by construction: padded ids point at
    real rows, masks zero their messages). DTensors: each rank gathers
    its own indices from the whole of x."""
    if not is_dtensor(idx):
        return x.index_select(0, idx)
    mesh = idx.device_mesh
    pl = list(idx.placements)
    return run_local(lambda xl, il: xl.index_select(0, il), (x, idx),
                     (placements(mesh, P()), pl), pl, mesh)


def scatter_rows(values, ids, num_segments: int):
    """:func:`scatter_sum` of rows; DTensors: each rank sums its own
    entries into a whole-size result, partial over the axes that split
    them (reduced by the next :func:`constrain` or op that needs it)."""
    if not is_dtensor(values):
        return scatter_sum(values, ids, num_segments)
    mesh = values.device_mesh
    pl = list(values.placements)
    out = [Partial() if isinstance(p, Shard) else p for p in pl]
    return run_local(lambda vl, il: scatter_sum(vl, il, num_segments),
                     (values, ids), (pl, pl), out, mesh)


def segment_sum_masked(values, ids, mask, num_segments: int):
    m = mask.to(values.dtype)
    values = values * (m[:, None] if values.dim() > 1 else m)
    return scatter_rows(values, ids, num_segments)


# ---------------------------------------------------------------------------
# Synthetic batches
# ---------------------------------------------------------------------------

def random_graph_batch(gen: torch.Generator, n_nodes: int, n_edges: int,
                       d_feat: int, n_graphs: int = 1,
                       with_pos: bool = False, n_classes: int = 8,
                       device=None) -> GraphBatch:
    """Synthetic padded graph batch (uniform random edges), drawn from the
    CPU generator ``gen`` and put on ``device`` (cuda by default)."""
    dev = resolve_device(device)
    src = torch.randint(0, n_nodes, (n_edges,), generator=gen,
                        dtype=torch.int32)
    dst = torch.randint(0, n_nodes, (n_edges,), generator=gen,
                        dtype=torch.int32)
    nodes = torch.randn((n_nodes, d_feat), generator=gen)
    gid = (torch.arange(n_nodes, dtype=torch.int32) * n_graphs) // n_nodes
    pos = torch.randn((n_nodes, 3), generator=gen) if with_pos else None
    labels = torch.randint(0, n_classes, (n_nodes,), generator=gen,
                           dtype=torch.int32)
    return GraphBatch(
        nodes=nodes.to(dev), edges_src=src.to(dev), edges_dst=dst.to(dev),
        edge_feat=torch.zeros((n_edges, 1), device=dev),
        node_mask=torch.ones(n_nodes, dtype=torch.bool, device=dev),
        edge_mask=torch.ones(n_edges, dtype=torch.bool, device=dev),
        graph_ids=gid.to(dev), n_graphs=n_graphs,
        positions=None if pos is None else pos.to(dev),
        labels=labels.to(dev))


def molecule_batch(gen: torch.Generator, batch: int, nodes_per_mol: int,
                   edges_per_mol: int, d_feat: int, device=None
                   ) -> GraphBatch:
    """Batched small molecular graphs (radius-graph style edges, both
    endpoints inside one molecule), from the CPU generator ``gen``."""
    dev = resolve_device(device)
    N = batch * nodes_per_mol
    E = batch * edges_per_mol
    pos = torch.randn((N, 3), generator=gen) * 2.0
    feats = torch.randn((N, d_feat), generator=gen)
    off = (torch.arange(E, dtype=torch.int32) // edges_per_mol) \
        * nodes_per_mol
    src = off + torch.randint(0, nodes_per_mol, (E,), generator=gen,
                              dtype=torch.int32)
    dst = off + torch.randint(0, nodes_per_mol, (E,), generator=gen,
                              dtype=torch.int32)
    gid = torch.arange(N, dtype=torch.int32) // nodes_per_mol
    labels = torch.randn((batch,), generator=gen)          # energies
    return GraphBatch(
        nodes=feats.to(dev), edges_src=src.to(dev), edges_dst=dst.to(dev),
        edge_feat=torch.zeros((E, 1), device=dev),
        node_mask=torch.ones(N, dtype=torch.bool, device=dev),
        edge_mask=(src != dst).to(dev), graph_ids=gid.to(dev),
        n_graphs=batch, positions=pos.to(dev), labels=labels.to(dev))


# ---------------------------------------------------------------------------
# Host-side topology builders (numpy copies of the reference's)
# ---------------------------------------------------------------------------

def build_triplets(src: np.ndarray, dst: np.ndarray, max_triplets: int):
    """DimeNet triplet index lists: pairs of directed edges (k->j, j->i)
    with k != i. Returns (edge_kj_idx, edge_ji_idx, mask), padded to
    max_triplets."""
    E = len(src)
    by_dst: dict[int, list[int]] = {}
    for e in range(E):
        by_dst.setdefault(int(dst[e]), []).append(e)
    t_kj, t_ji = [], []
    for e_ji in range(E):
        j = int(src[e_ji])
        i = int(dst[e_ji])
        for e_kj in by_dst.get(j, ()):
            if int(src[e_kj]) != i:
                t_kj.append(e_kj)
                t_ji.append(e_ji)
                if len(t_kj) >= max_triplets:
                    break
        if len(t_kj) >= max_triplets:
            break
    n = len(t_kj)
    kj = np.zeros(max_triplets, np.int32)
    ji = np.zeros(max_triplets, np.int32)
    m = np.zeros(max_triplets, bool)
    kj[:n] = t_kj
    ji[:n] = t_ji
    m[:n] = True
    return kj, ji, m


def icosphere(refinement: int):
    """Icosahedron subdivided ``refinement`` times: (verts (V,3), undirected
    edges (E,2)). V = 10*4^r + 2, E = 30*4^r."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    for _ in range(refinement):
        verts_l = verts.tolist()
        midpoint: dict[tuple[int, int], int] = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in midpoint:
                m = np.array(verts_l[a]) + np.array(verts_l[b])
                m /= np.linalg.norm(m)
                midpoint[key] = len(verts_l)
                verts_l.append(m.tolist())
            return midpoint[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        faces = np.array(new_faces, dtype=np.int64)
        verts = np.array(verts_l)
    edges = set()
    for a, b, c in faces:
        for x, y in ((a, b), (b, c), (c, a)):
            edges.add((min(x, y), max(x, y)))
    return verts.astype(np.float32), np.array(sorted(edges), dtype=np.int32)
