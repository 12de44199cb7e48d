"""EGNN — E(n)-equivariant graph network [arXiv:2102.09844] (port of
``repro.models.gnn.egnn``).

m_ij   = φ_e(h_i, h_j, ||x_i − x_j||², e_ij)
x_i'   = x_i + C Σ_j (x_i − x_j) φ_x(m_ij)
h_i'   = φ_h(h_i, Σ_j m_ij)

Scalar-distance messages + coordinate updates — no spherical harmonics.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn.common import (
    GraphBatch, constrain, layer_remat, mlp_apply, mlp_init, scatter_rows,
    segment_sum_masked, take,
)


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    task: str = "energy"      # graph-level energy regression


def init_params(cfg: EGNNConfig, gen: torch.Generator) -> dict:
    """Params on ``gen``'s device."""
    d = cfg.d_hidden
    layers = [{"phi_e": mlp_init(gen, [2 * d + 2, d, d]),
               "phi_x": mlp_init(gen, [d, d, 1]),
               "phi_h": mlp_init(gen, [2 * d, d, d])}
              for _ in range(cfg.n_layers)]
    return {"embed": mlp_init(gen, [cfg.d_in, d]),
            "layers": layers,
            "readout": mlp_init(gen, [d, d, 1])}


def forward(cfg: EGNNConfig, params, g: GraphBatch):
    """Returns (per-graph energy (n_graphs,), final node feats, coords)."""
    N = g.nodes.shape[0]
    h = mlp_apply(params["embed"], g.nodes)
    x = g.positions
    src, dst = g.edges_src, g.edges_dst
    em = g.edge_mask
    ef = g.edge_feat[:, :1].to(h.dtype)

    def one_layer(lp, h, x):
        diff = take(x, dst) - take(x, src)
        d2 = (diff * diff).sum(-1, keepdim=True)
        feat = torch.cat([take(h, src), take(h, dst), d2.to(h.dtype), ef],
                         -1)
        m = mlp_apply(lp["phi_e"], feat, final_act=True)        # (E, d)
        w = mlp_apply(lp["phi_x"], m)                            # (E, 1)
        upd = diff * torch.tanh(w.to(diff.dtype))
        x = x + segment_sum_masked(upd, dst, em, N) / 8.0
        agg = segment_sum_masked(m, dst, em, N)
        h = (h + mlp_apply(lp["phi_h"],
                           torch.cat([h, agg], -1))).to(h.dtype)
        return constrain(h), constrain(x)

    one_layer = layer_remat(one_layer)
    h, x = constrain(h), constrain(x)
    for lp in params["layers"]:
        h, x = one_layer(lp, h, x)
    node_e = mlp_apply(params["readout"], h)[:, 0]
    node_e = node_e * g.node_mask.to(node_e.dtype)
    energy = scatter_rows(node_e, g.graph_ids, g.n_graphs)
    return energy, h, x


def node_repr(cfg: EGNNConfig, params, g: GraphBatch):
    """Per-node representation (N, d_hidden) for classification heads."""
    return forward(cfg, params, g)[1]


def loss_fn(cfg: EGNNConfig, params, g: GraphBatch):
    energy = forward(cfg, params, g)[0]
    return torch.mean((energy - g.labels) ** 2)
