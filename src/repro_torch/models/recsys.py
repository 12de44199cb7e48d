"""Wide & Deep recommender [arXiv:1606.07792] (port of
``repro.models.recsys``).

40 sparse categorical fields → EmbeddingBag lookups (the hot path) +
13 dense features. Wide side: linear over per-field 1-dim embeddings +
dense. Deep side: concat 32-dim embeddings → MLP 1024-512-256 → logit.

Differences from the JAX module:

- The reference looks up the fields by ``jax.vmap`` over the (F, V, D)
  tables; here every field is one gather over the tables viewed as
  (F·V, D), with index f·V + i (one launch instead of F).
- The tables' gradient is dense, as the reference's is: AdamW's weight
  decay touches every row, so a sparse gradient would compute another
  update.
- With DTensor tables, row-sharded over the model axis
  (:func:`param_pspecs`, DLRM-style table sharding), the one gather runs
  under ``local_map``: each rank looks up the indices in its row range
  of every field (zero elsewhere), and the partial sums over the model
  axis (one nonzero term per element) are reduced across it, the
  reference's one-hot-partitioned gather and all-reduce.

``retrieval_score`` covers the retrieval_cand shape: one query embedding
against 10⁶ candidate item embeddings as a single matrix-vector product.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import P, is_dtensor, local_offset, run_local
from repro_torch.sparse.embedding_bag import embedding_bag


@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    n_dense: int = 13
    embed_dim: int = 32
    vocab_per_field: int = 1_000_000
    mlp_dims: tuple = (1024, 512, 256)
    multi_hot: int = 1       # indices per field (bag size)
    cand_dim: int = 64       # retrieval tower output dim


def init_params(cfg: WideDeepConfig, gen: torch.Generator) -> dict:
    """Params on ``gen``'s device: tables uniform in [-1/sqrt(D),
    1/sqrt(D)), MLP weights normal / sqrt(fan-in), zero biases."""
    V, Fd, D = cfg.vocab_per_field, cfg.n_sparse, cfg.embed_dim
    dev = gen.device
    s = 1.0 / math.sqrt(D)

    def uniform(shape):
        return torch.rand(shape, generator=gen, device=dev) \
            .mul_(2 * s).sub_(s)

    dims = (Fd * D + cfg.n_dense,) + tuple(cfg.mlp_dims) + (1,)
    return {
        "tables": uniform((Fd, V, D)),
        "wide_tables": uniform((Fd, V, 1)),
        "wide_dense": torch.randn((cfg.n_dense, 1), generator=gen,
                                  device=dev).mul_(0.01),
        "mlp_w": [torch.randn((a, b), generator=gen, device=dev)
                  .div_(math.sqrt(a)) for a, b in zip(dims[:-1], dims[1:])],
        "mlp_b": [torch.zeros((b,), device=dev) for b in dims[1:]],
        "bias": torch.zeros((1,), device=dev),
    }


def param_pspecs(cfg: WideDeepConfig, model_axis="model"):
    n = len(cfg.mlp_dims) + 1
    return {
        "tables": P(None, model_axis, None),
        "wide_tables": P(None, model_axis, None),
        "wide_dense": P(None, None),
        "mlp_w": [P(None, None) for _ in range(n)],
        "mlp_b": [P(None) for _ in range(n)],
        "bias": P(None),
    }


def _lookup(tables, flat_idx, mask):
    """Sum-bags of every field in one gather: tables (F, V, d), flat_idx
    (B, F, bag) = f·V + i -> (B, F, d)."""
    if is_dtensor(tables):
        return _lookup_sharded(tables, flat_idx, mask)
    Fd, V, d = tables.shape
    return embedding_bag(tables.reshape(Fd * V, d), flat_idx, mask,
                         mode="sum")


def _lookup_sharded(tables, flat_idx, mask):
    """:func:`_lookup` of row-sharded DTensor tables under ``local_map``:
    each rank's tables hold rows [lo, lo + V_loc) of every field; an
    index outside them adds a zero row. The result is a partial sum over
    the axes that split the rows, reduced here to the batch's placements."""
    from torch.distributed.tensor import Partial, Shard
    mesh = tables.device_mesh
    Fd, V, d = tables.shape
    t_pl = list(tables.placements)
    lo = local_offset(mesh, t_pl, tables.shape)[1]
    i_pl = list(flat_idx.placements)
    out_pl = [Partial() if isinstance(tp, Shard) else ip
              for tp, ip in zip(t_pl, i_pl)]

    def lookup(tl, il, ml):
        n = tl.shape[1]
        f, i = il // V, il % V
        ok = (i >= lo) & (i < lo + n)
        if ml is not None:
            ok = ok & ml
        local = f * n + (i - lo).clamp(0, n - 1)
        return embedding_bag(tl.reshape(Fd * n, d), local, ok, mode="sum")

    if mask is None:
        out = run_local(lambda tl, il: lookup(tl, il, None),
                        (tables, flat_idx), (t_pl, i_pl), out_pl, mesh)
    else:
        out = run_local(lookup, (tables, flat_idx, mask),
                        (t_pl, i_pl, i_pl), out_pl, mesh)
    return out.redistribute(mesh, i_pl)


def forward(cfg: WideDeepConfig, params, sparse_idx, dense_feats,
            sparse_mask=None):
    """sparse_idx: (B, F, bag) int32 (each below vocab_per_field);
    dense_feats: (B, n_dense). Returns logits (B,)."""
    B = sparse_idx.shape[0]
    Fd, D, V = cfg.n_sparse, cfg.embed_dim, cfg.vocab_per_field
    offs = torch.arange(Fd, dtype=torch.int64, device=sparse_idx.device) * V
    flat = sparse_idx.long() + offs[None, :, None]
    emb = _lookup(params["tables"], flat, sparse_mask)          # (B, F, D)
    wide_e = _lookup(params["wide_tables"], flat, sparse_mask)  # (B, F, 1)

    wide = wide_e.sum((1, 2)) + (dense_feats @ params["wide_dense"])[:, 0]
    deep = torch.cat([emb.reshape(B, Fd * D), dense_feats], -1)
    n = len(params["mlp_w"])
    for i, (w, b) in enumerate(zip(params["mlp_w"], params["mlp_b"])):
        deep = deep @ w + b
        if i < n - 1:
            deep = F.relu(deep)
    return wide + deep[:, 0] + params["bias"][0]


def loss_fn(cfg: WideDeepConfig, params, sparse_idx, dense_feats, labels,
            sparse_mask=None):
    """Binary cross-entropy on the logits (the reference's stable form)."""
    logits = forward(cfg, params, sparse_idx, dense_feats, sparse_mask)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def retrieval_score(query_emb, cand_embs):
    """retrieval_cand cell: (d,) query vs (n_cand, d) candidates → scores."""
    return cand_embs @ query_emb
