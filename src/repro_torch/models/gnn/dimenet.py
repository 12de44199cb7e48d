"""DimeNet — directional message passing [arXiv:2003.03123] (port of
``repro.models.gnn.dimenet``).

Directed edge messages m_ji updated from triplet interactions (k→j→i) with a
radial basis on distances and an angular×radial basis on (d_kj, θ_kji),
combined through a bilinear tensor (n_bilinear).

As in the reference, the spherical Bessel/Legendre 2D basis is a
separable sin-radial × Chebyshev-angular basis of the same rank
(n_spherical × n_radial), and triplet index lists are precomputed on the
host and padded (``common.build_triplets``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.gnn.common import (
    GraphBatch, constrain, layer_remat, mlp_apply, mlp_init, scatter_rows,
    take,
)


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    d_in: int = 16


def radial_basis(d, n_radial: int, cutoff: float):
    """sin(nπ d/c)/d Bessel-style radial basis with smooth cutoff."""
    d = torch.clamp(d, min=1e-3)
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    u = d[..., None] / cutoff
    env = torch.where(u < 1.0, 0.5 * (torch.cos(math.pi * u) + 1.0),
                      torch.zeros_like(u))
    return env * torch.sin(n * math.pi * u) / d[..., None]


def angular_radial_basis(d, cos_theta, n_spherical: int, n_radial: int,
                         cutoff: float):
    """Separable (angular Chebyshev) × (radial sin) basis, rank S*R."""
    rb = radial_basis(d, n_radial, cutoff)                # (..., R)
    theta = torch.arccos(torch.clamp(cos_theta, -1 + 1e-6, 1 - 1e-6))
    s = torch.arange(n_spherical, dtype=torch.float32, device=d.device)
    ab = torch.cos(s * theta[..., None])                  # (..., S)
    return (ab[..., :, None] * rb[..., None, :]).reshape(
        *d.shape, n_spherical * n_radial)


def init_params(cfg: DimeNetConfig, gen: torch.Generator) -> dict:
    """Params on ``gen``'s device."""
    d, B = cfg.d_hidden, cfg.n_bilinear
    SR = cfg.n_spherical * cfg.n_radial
    dev = gen.device
    blocks = [{
        "w_sbf": torch.randn((SR, B), generator=gen, device=dev)
        / SR ** 0.5,
        "w_bil": torch.randn((B, d, d), generator=gen, device=dev)
        / (B * d) ** 0.5,
        "msg_kj": mlp_init(gen, [d, d]),
        "msg_ji": mlp_init(gen, [d, d]),
        "update": mlp_init(gen, [d, d, d]),
        "out": mlp_init(gen, [d, d]),
    } for _ in range(cfg.n_blocks)]
    return {
        "embed_node": mlp_init(gen, [cfg.d_in, d]),
        "embed_edge": mlp_init(gen, [2 * d + cfg.n_radial, d]),
        "rbf_proj": mlp_init(gen, [cfg.n_radial, d]),
        "readout": mlp_init(gen, [d, d, 1]),
        "blocks": blocks,
    }


def _bilinear(a, w_bil, x):
    """einsum("tb,bhf,th->tf", a, w_bil, x) as one (T, h) x (h, B f)
    product and a (T, 1, B) x (T, B, f) batched product: no (T, h, f)
    intermediate."""
    B, h, f = w_bil.shape
    y = (x @ w_bil.permute(1, 0, 2).reshape(h, B * f)).reshape(-1, B, f)
    return torch.bmm(a[:, None, :], y)[:, 0]


def _trunk(cfg: DimeNetConfig, params, g: GraphBatch, tri_kj, tri_ji,
           tri_mask):
    """Shared trunk returning (final edge messages m, per-node energy acc)."""
    N, E = g.nodes.shape[0], g.edges_src.shape[0]
    src, dst = g.edges_src, g.edges_dst
    pos = g.positions
    vec = take(pos, dst) - take(pos, src)
    dist = torch.sqrt((vec * vec).sum(-1) + 1e-12)
    rbf = radial_basis(dist, cfg.n_radial, cfg.cutoff)     # (E, R)

    h = mlp_apply(params["embed_node"], g.nodes)
    rbf = rbf.to(h.dtype)
    m = mlp_apply(params["embed_edge"], torch.cat(
        [take(h, src), take(h, dst), rbf], -1))             # (E, d)
    rbf_d = mlp_apply(params["rbf_proj"], rbf)             # (E, d)

    # triplet geometry: angle between (k→j) and (j→i) at node j
    v_kj = take(vec, tri_kj)
    v_ji = take(vec, tri_ji)
    cosang = (-v_kj * v_ji).sum(-1) / (
        torch.linalg.norm(v_kj, dim=-1) * torch.linalg.norm(v_ji, dim=-1)
        + 1e-9)
    sbf = angular_radial_basis(take(dist, tri_kj), cosang, cfg.n_spherical,
                               cfg.n_radial, cfg.cutoff).to(h.dtype)
    tmask = tri_mask[:, None]
    emask = g.edge_mask[:, None]

    def one_block(bp, m, energy_acc):
        x_kj = constrain(take(mlp_apply(bp["msg_kj"], m, final_act=True),
                              tri_kj))
        a = sbf @ bp["w_sbf"].to(sbf.dtype)                 # (T, B)
        tri_msg = _bilinear(a, bp["w_bil"].to(a.dtype), x_kj)
        tri_msg = tri_msg * tmask.to(tri_msg.dtype)
        # constrained: a scatter over split triplets is otherwise a whole
        # (E, d) partial sum on every rank
        agg = constrain(scatter_rows(tri_msg, tri_ji, E))
        dt = m.dtype
        m = m + mlp_apply(bp["update"],
                          mlp_apply(bp["msg_ji"], m, final_act=True)
                          + agg.to(dt))
        m = (m * rbf_d).to(dt)      # re-modulate by radial envelope
        e_contrib = mlp_apply(bp["out"], m)
        node_e = scatter_rows(e_contrib * emask.to(e_contrib.dtype), dst,
                              N)
        return constrain(m), energy_acc + node_e.float().sum(-1) \
            / cfg.d_hidden

    one_block = layer_remat(one_block)
    energy_acc = torch.zeros((N,), dtype=torch.float32, device=m.device)
    m = constrain(m)
    for bp in params["blocks"]:
        m, energy_acc = one_block(bp, m, energy_acc)
    return m, energy_acc


def _node_sum(m, g: GraphBatch):
    return scatter_rows(m * g.edge_mask[:, None].to(m.dtype), g.edges_dst,
                        g.nodes.shape[0])


def node_repr(cfg: DimeNetConfig, params, g: GraphBatch, tri_kj, tri_ji,
              tri_mask):
    """Per-node representation (N, d_hidden): aggregated final messages."""
    return _node_sum(_trunk(cfg, params, g, tri_kj, tri_ji, tri_mask)[0], g)


def forward(cfg: DimeNetConfig, params, g: GraphBatch, tri_kj, tri_ji,
            tri_mask):
    """Per-graph energies (the molecular-property task)."""
    m, energy_acc = _trunk(cfg, params, g, tri_kj, tri_ji, tri_mask)
    node_e = mlp_apply(params["readout"], _node_sum(m, g))[:, 0] \
        + energy_acc
    node_e = node_e * g.node_mask.to(node_e.dtype)
    return scatter_rows(node_e, g.graph_ids, g.n_graphs)


def loss_fn(cfg: DimeNetConfig, params, g: GraphBatch, tri_kj, tri_ji,
            tri_mask):
    energy = forward(cfg, params, g, tri_kj, tri_ji, tri_mask)
    return torch.mean((energy - g.labels) ** 2)
