"""MACE — higher-order equivariant message passing [arXiv:2206.07697]
(port of ``repro.models.gnn.mace``).

As in the reference, irreps are carried in the *Cartesian tensor*
representation instead of complex spherical-harmonic bases — l=0 scalars
(N, C), l=1 vectors (N, C, 3), l=2 symmetric-traceless matrices (N, C, 3, 3).
All Clebsch-Gordan products become explicit tensor algebra (dot, cross,
symmetric-traceless outer/matmul, Frobenius, ε-contractions), which is
equivariant by construction. Correlation order 3 = iterated pairwise
products A, A⊗A, (A⊗A)⊗A, capped at l_max = 2, with learnable per-path
weights.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.models.gnn.common import (
    GraphBatch, constrain, layer_remat, mlp_apply, mlp_init, scatter_rows,
    take,
)
from repro_torch.models.gnn.dimenet import radial_basis


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128     # channels per irrep
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    d_in: int = 16


# --- Cartesian irrep algebra ------------------------------------------------

def _symtraceless(M):
    S = 0.5 * (M + M.transpose(-1, -2))
    tr = S.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    return S - tr * eye / 3.0


def _promoted(*xs):
    """``xs`` in their common dtype, as ``jnp`` promotes mixed operands
    (a bf16 trunk meets the float32 Levi-Civita tensor and float32
    products: the result is float32, as the reference's)."""
    dt = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return [x.to(dt) for x in xs]


def _einsum(eq, *ops):
    return torch.einsum(eq, *_promoted(*ops))


def _cross(u, v):
    return torch.linalg.cross(*_promoted(u, v), dim=-1)


def _eps(like):
    """The Levi-Civita tensor (3, 3, 3), float32 as the reference's, on
    ``like``'s device."""
    e = torch.zeros((3, 3, 3), dtype=torch.float32, device=like.device)
    for (i, j, k, s) in [(0, 1, 2, 1), (1, 2, 0, 1), (2, 0, 1, 1),
                         (0, 2, 1, -1), (2, 1, 0, -1), (1, 0, 2, -1)]:
        e[i, j, k] = float(s)
    return e


def pairwise_products(x, y):
    """All bilinear equivariant products of irrep dicts x, y (l ≤ 2).
    Returns dict l -> list of product tensors (the reference's order)."""
    out = {0: [], 1: [], 2: []}
    # 0 x l
    if 0 in x:
        for l in (0, 1, 2):
            if l in y:
                s = x[0][..., None] if l == 1 else (
                    x[0][..., None, None] if l == 2 else x[0])
                out[l].append(s * y[l])
    # 1 x 0 / 2 x 0
    if 0 in y:
        if 1 in x:
            out[1].append(x[1] * y[0][..., None])
        if 2 in x:
            out[2].append(x[2] * y[0][..., None, None])
    # 1 x 1
    if 1 in x and 1 in y:
        out[0].append((x[1] * y[1]).sum(-1))
        out[1].append(_cross(x[1], y[1]))
        outer = x[1][..., :, None] * y[1][..., None, :]
        out[2].append(_symtraceless(outer))
    # 1 x 2 : matvec and ε-contraction
    if 1 in x and 2 in y:
        out[1].append(_einsum("...ij,...j->...i", y[2], x[1]))
        eps_m = _einsum("ikl,...k,...lj->...ij", _eps(x[1]), x[1], y[2])
        out[2].append(_symtraceless(eps_m))
    if 2 in x and 1 in y:
        out[1].append(_einsum("...ij,...j->...i", x[2], y[1]))
    # 2 x 2
    if 2 in x and 2 in y:
        out[0].append(_einsum("...ij,...ij->...", x[2], y[2]))
        mn = _einsum("...ij,...jk->...ik", x[2], y[2])
        out[1].append(_einsum("ijk,...jk->...i", _eps(mn), mn))
        out[2].append(_symtraceless(mn))
    return {l: v for l, v in out.items() if v}


def spherical_cartesian(rhat):
    """Y0 = 1, Y1 = r̂, Y2 = symtraceless(r̂ r̂ᵀ). rhat: (..., 3)."""
    y0 = torch.ones(rhat.shape[:-1], dtype=rhat.dtype, device=rhat.device)
    y2 = _symtraceless(rhat[..., :, None] * rhat[..., None, :])
    return {0: y0, 1: rhat, 2: y2}


# --- model ------------------------------------------------------------------

def init_params(cfg: MACEConfig, gen: torch.Generator) -> dict:
    """Params on ``gen``'s device."""
    C = cfg.d_hidden
    dev = gen.device

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    layers = [{
        # radial MLP -> per-l path weights for the message products
        "radial": mlp_init(gen, [cfg.n_rbf, 32, 3 * C]),
        # channel mixing per l after aggregation
        "mix0": normal((C, C), C ** -0.5),
        "mix1": normal((C, C), C ** -0.5),
        "mix2": normal((C, C), C ** -0.5),
        # per-path weights of the correlation products
        "corr_w0": normal((8, C), 0.1),
        "corr_w1": normal((8, C), 0.1),
        "corr_w2": normal((8, C), 0.1),
        "update0": mlp_init(gen, [C, C]),
    } for _ in range(cfg.n_layers)]
    return {
        "embed": mlp_init(gen, [cfg.d_in, C]),
        "layers": layers,
        "readout": mlp_init(gen, [C, C, 1]),
    }


def _mix(h, w):
    """Channel mixing: (N, C, ...) x (C, C) -> (N, C, ...)."""
    return torch.einsum("nc...,cd->nd...", h, w.to(h.dtype))


def _weighted_stack(products: list, w):
    """Combine up to 8 product tensors with per-channel weights (8, C)."""
    acc = None
    for i, p in enumerate(products[:8]):
        wi = w[i].reshape((1, -1) + (1,) * (p.dim() - 2))
        acc = p * wi if acc is None else acc + p * wi
    return acc


def node_repr(cfg: MACEConfig, params, g: GraphBatch):
    """Per-node invariant representation (N, C) for classification heads."""
    return _trunk(cfg, params, g)[0]


def forward(cfg: MACEConfig, params, g: GraphBatch):
    h0 = node_repr(cfg, params, g)
    node_e = mlp_apply(params["readout"], h0)[:, 0]
    node_e = node_e * g.node_mask.to(node_e.dtype)
    return scatter_rows(node_e, g.graph_ids, g.n_graphs)


def _trunk(cfg: MACEConfig, params, g: GraphBatch):
    N = g.nodes.shape[0]
    C = cfg.d_hidden
    src, dst = g.edges_src, g.edges_dst
    vec = take(g.positions, dst) - take(g.positions, src)
    dist = torch.sqrt((vec * vec).sum(-1) + 1e-12)
    rhat = vec / (dist[..., None] + 1e-9)
    Y = spherical_cartesian(rhat)          # per-edge Cartesian harmonics
    rbf = radial_basis(dist, cfg.n_rbf, cfg.cutoff)

    h0 = mlp_apply(params["embed"], g.nodes)
    h = {0: h0,
         1: h0.new_zeros((N, C, 3)),
         2: h0.new_zeros((N, C, 3, 3))}
    Ye = {0: Y[0][:, None].to(h0.dtype), 1: Y[1][:, None, :].to(h0.dtype),
          2: Y[2][:, None, :, :].to(h0.dtype)}
    rbf = rbf.to(h0.dtype)
    em = g.edge_mask.to(h0.dtype)

    def one_layer(lp, h):
        Rw = mlp_apply(lp["radial"], rbf).reshape(-1, 3, C)   # (E, 3, C)
        # message: h_j ⊗ Y_ij per output l, radially weighted
        hj = {l: take(h[l], src) for l in h}
        prods = pairwise_products(hj, Ye)
        msg = {}
        for l in (0, 1, 2):
            if l not in prods:
                continue
            stacked = sum(prods[l][:4]) if len(prods[l]) > 1 \
                else prods[l][0]
            wl = Rw[:, l, :].reshape((-1, C) + (1,) * (stacked.dim() - 2))
            m = stacked * wl * em.reshape((-1,) + (1,) * (stacked.dim() - 1))
            msg[l] = constrain(scatter_rows(m, dst, N))
        A = {l: msg[l] if l in msg else torch.zeros_like(h[l]) for l in h}

        # correlation order 3: B1 = A, B2 = A⊗A, B3 = B2⊗A (capped at l≤2)
        B2 = {l: sum(v[:4]) for l, v in pairwise_products(A, A).items()}
        B3 = {l: sum(v[:4]) for l, v in pairwise_products(B2, A).items()}
        corr = {}
        for l, wkey in ((0, "corr_w0"), (1, "corr_w1"), (2, "corr_w2")):
            parts = [A[l]]
            if l in B2:
                parts.append(B2[l])
            if l in B3 and cfg.correlation >= 3:
                parts.append(B3[l])
            corr[l] = _weighted_stack(parts, lp[wkey])

        dt = {l: v.dtype for l, v in h.items()}
        h = {0: h[0] + mlp_apply(lp["update0"], _mix(corr[0], lp["mix0"])),
             1: h[1] + _mix(corr[1], lp["mix1"]),
             2: h[2] + _mix(corr[2], lp["mix2"])}
        return {l: constrain(v.to(dt[l])) for l, v in h.items()}

    one_layer = layer_remat(one_layer)
    h = {l: constrain(v) for l, v in h.items()}
    for lp in params["layers"]:
        h = one_layer(lp, h)
    return h[0], h


def loss_fn(cfg: MACEConfig, params, g: GraphBatch):
    energy = forward(cfg, params, g)
    return torch.mean((energy - g.labels) ** 2)
