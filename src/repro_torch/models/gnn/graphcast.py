"""GraphCast-style encoder–processor–decoder mesh GNN [arXiv:2212.12794]
(port of ``repro.models.gnn.graphcast``).

Grid nodes (lat/lon, n_vars=227 channels) are encoded onto an icosahedral
mesh (refinement 6 → 40962 mesh nodes), processed by 16 GraphNet layers over
multi-scale mesh edges, and decoded back to the grid. Each GraphNet block:
edge MLP([e, h_src, h_dst]) → e'; node MLP([h, Σ_in e']) → h'; residual +
LayerNorm — aggregation is a scatter sum over the static edge lists.

The topology is built on the host with numpy exactly as the reference
builds it (the same ``default_rng(seed).choice``), so it is identical.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import resolve_device
from repro_torch.models.gnn.common import (
    constrain, icosphere, layer_norm, layer_remat, mlp_apply, mlp_init,
    scatter_rows, take,
)
from repro_torch.sparse.segment_ops import scatter_sum


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    mesh_refinement: int = 6
    n_vars: int = 227
    grid_lat: int = 181      # 1° resolution
    grid_lon: int = 360
    g2m_per_grid: int = 4    # grid→mesh edges per grid node
    m2g_per_grid: int = 3    # mesh→grid edges per grid node

    @property
    def n_grid(self) -> int:
        return self.grid_lat * self.grid_lon

    @property
    def n_mesh(self) -> int:
        return 10 * 4 ** self.mesh_refinement + 2

    @property
    def n_mesh_edges(self) -> int:
        # multi-scale: all refinement levels' edge sets, directed
        return 2 * sum(30 * 4 ** r for r in range(self.mesh_refinement + 1))

    @property
    def n_g2m_edges(self) -> int:
        return self.n_grid * self.g2m_per_grid

    @property
    def n_m2g_edges(self) -> int:
        return self.n_grid * self.m2g_per_grid


class MeshTopology(NamedTuple):
    mesh_src: torch.Tensor     # (Em,) int32
    mesh_dst: torch.Tensor
    g2m_src: torch.Tensor      # (Eg2m,) grid index
    g2m_dst: torch.Tensor      # (Eg2m,) mesh index
    m2g_src: torch.Tensor      # (Em2g,) mesh index
    m2g_dst: torch.Tensor      # (Em2g,) grid index


def build_topology(cfg: GraphCastConfig, seed: int = 0,
                   device=None) -> MeshTopology:
    """Host-side topology: true icosphere multi-scale mesh edges + nearest-
    mesh-node grid connections, put on ``device`` (cuda by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    verts, _ = icosphere(cfg.mesh_refinement)
    all_src, all_dst = [], []
    for r in range(cfg.mesh_refinement + 1):
        _, e = icosphere(r)
        # vertices of refinement r are a prefix of refinement R's vertices
        all_src += [e[:, 0], e[:, 1]]
        all_dst += [e[:, 1], e[:, 0]]
    mesh_src = np.concatenate(all_src).astype(np.int32)
    mesh_dst = np.concatenate(all_dst).astype(np.int32)

    # grid positions on the sphere
    lat = (np.arange(cfg.grid_lat) / max(cfg.grid_lat - 1, 1) - 0.5) * np.pi
    lon = np.arange(cfg.grid_lon) / cfg.grid_lon * 2 * np.pi
    LA, LO = np.meshgrid(lat, lon, indexing="ij")
    gp = np.stack([np.cos(LA) * np.cos(LO), np.cos(LA) * np.sin(LO),
                   np.sin(LA)], -1).reshape(-1, 3).astype(np.float32)
    # nearest mesh nodes per grid node (approx: sample candidates)
    n_cand = min(len(verts), 4096)
    cand = rng.choice(len(verts), size=n_cand, replace=False)
    d = gp @ verts[cand].T                      # cosine similarity
    k = max(cfg.g2m_per_grid, cfg.m2g_per_grid)
    nearest = cand[np.argsort(-d, axis=1)[:, :k]]
    g_idx = np.repeat(np.arange(cfg.n_grid, dtype=np.int32),
                      cfg.g2m_per_grid)
    g2m_dst = nearest[:, :cfg.g2m_per_grid].reshape(-1).astype(np.int32)
    m2g_src = nearest[:, :cfg.m2g_per_grid].reshape(-1).astype(np.int32)
    m_idx = np.repeat(np.arange(cfg.n_grid, dtype=np.int32),
                      cfg.m2g_per_grid)
    return MeshTopology(*(torch.from_numpy(a).to(dev) for a in (
        mesh_src, mesh_dst, g_idx, g2m_dst, m2g_src, m_idx)))


def _gnet_layers(gen: torch.Generator, cfg: GraphCastConfig) -> list:
    d = cfg.d_hidden
    return [{"edge": mlp_init(gen, [3 * d, d, d]),
             "node": mlp_init(gen, [2 * d, d, d])}
            for _ in range(cfg.n_layers)]


def init_params(cfg: GraphCastConfig, gen: torch.Generator) -> dict:
    """Params of the native weather path, on ``gen``'s device."""
    d = cfg.d_hidden
    return {
        "grid_enc": mlp_init(gen, [cfg.n_vars, d, d]),
        "mesh_init": mlp_init(gen, [3, d, d]),    # mesh pos features
        "g2m_edge": mlp_init(gen, [2 * d, d, d]),
        "g2m_node": mlp_init(gen, [2 * d, d, d]),
        "layers": _gnet_layers(gen, cfg),
        "m2g_edge": mlp_init(gen, [2 * d, d, d]),
        "m2g_node": mlp_init(gen, [2 * d, d, d]),
        "grid_dec": mlp_init(gen, [d, d, cfg.n_vars]),
        "mesh_pos": None,  # set lazily from topology if needed
    }


def _gnet_block(lp, h, e_src, e_dst, e_feat, n_nodes):
    msg_in = torch.cat([e_feat, take(h, e_src), take(h, e_dst)], -1)
    e_new = e_feat + mlp_apply(lp["edge"], msg_in)
    agg = scatter_sum(e_new, e_dst, n_nodes)
    h_new = h + mlp_apply(lp["node"], torch.cat([h, agg], -1))
    return layer_norm(h_new), layer_norm(e_new)


def forward(cfg: GraphCastConfig, params, grid_feats, topo: MeshTopology,
            mesh_pos=None):
    """grid_feats: (n_grid, n_vars) → next-state prediction, same shape."""
    d = cfg.d_hidden
    n_grid, n_mesh = cfg.n_grid, cfg.n_mesh
    hg = mlp_apply(params["grid_enc"], grid_feats)          # (G, d)
    if mesh_pos is None:
        mesh_pos = torch.zeros((n_mesh, 3), dtype=grid_feats.dtype,
                               device=grid_feats.device)
    hm = mlp_apply(params["mesh_init"], mesh_pos)           # (M, d)

    # encoder: grid -> mesh
    e = mlp_apply(params["g2m_edge"], torch.cat(
        [take(hg, topo.g2m_src), take(hm, topo.g2m_dst)], -1))
    agg = scatter_sum(e, topo.g2m_dst, n_mesh)
    hm = layer_norm(hm + mlp_apply(params["g2m_node"],
                                   torch.cat([hm, agg], -1)))

    # processor: multi-scale mesh GNN
    em = torch.zeros((topo.mesh_src.shape[0], d), dtype=hm.dtype,
                     device=hm.device)
    block = layer_remat(lambda lp, hm, em: _gnet_block(
        lp, hm, topo.mesh_src, topo.mesh_dst, em, n_mesh))
    for lp in params["layers"]:
        hm, em = block(lp, hm, em)

    # decoder: mesh -> grid
    e = mlp_apply(params["m2g_edge"], torch.cat(
        [take(hm, topo.m2g_src), take(hg, topo.m2g_dst)], -1))
    agg = scatter_sum(e, topo.m2g_dst, n_grid)
    hg = layer_norm(hg + mlp_apply(params["m2g_node"],
                                   torch.cat([hg, agg], -1)))
    return grid_feats + mlp_apply(params["grid_dec"], hg)


def loss_fn(cfg: GraphCastConfig, params, grid_feats, target, topo):
    pred = forward(cfg, params, grid_feats, topo)
    return torch.mean((pred - target) ** 2)


# ---------------------------------------------------------------------------
# processor mode: run the 16-layer GraphNet stack directly on an arbitrary
# input graph (the registry's graph-benchmark shapes; the native
# encoder/decoder path above is exercised by the weather example).
# ---------------------------------------------------------------------------

def init_processor_params(cfg: GraphCastConfig, gen: torch.Generator,
                          d_in: int) -> dict:
    d = cfg.d_hidden
    return {"enc": mlp_init(gen, [d_in, d, d]),
            "layers": _gnet_layers(gen, cfg),
            "dec": mlp_init(gen, [d, d, d])}


def processor_node_repr(cfg: GraphCastConfig, params, nodes, src, dst,
                        edge_mask=None):
    """nodes: (N, d_in) → per-node hidden (N, d_hidden); masked edges
    carry no message."""
    N = nodes.shape[0]
    h = mlp_apply(params["enc"], nodes)
    e = torch.zeros((src.shape[0], cfg.d_hidden), dtype=h.dtype,
                    device=h.device)
    em = None if edge_mask is None else edge_mask[:, None].to(h.dtype)

    def one_layer(lp, h, e):
        msg_in = torch.cat([e, take(h, src), take(h, dst)], -1)
        e_new = e + mlp_apply(lp["edge"], msg_in)
        if em is not None:
            e_new = e_new * em
        agg = scatter_rows(e_new, dst, N)
        h_new = layer_norm(h + mlp_apply(lp["node"],
                                         torch.cat([h, agg], -1)))
        return (constrain(h_new.to(h.dtype)),
                constrain(layer_norm(e_new).to(e.dtype)))

    one_layer = layer_remat(one_layer)
    h, e = constrain(h), constrain(e)
    for lp in params["layers"]:
        h, e = one_layer(lp, h, e)
    return mlp_apply(params["dec"], h)
