"""Deterministic synthetic data (step -> batch), one per model family,
after the JAX package's ``data/synthetic.py``. Determinism in (seed,
step) is what makes a restored checkpoint resume the same trajectory.

The port cannot reproduce the bits of ``jax.random``: each batch has the
JAX batch's structure drawn from a CPU ``torch.Generator`` seeded by
(seed, step) and is then put on ``device`` (cuda by default), so the same
(seed, step) gives the same batch on every device, and other values than
the JAX package's. ``lm_batch``: random base tokens repeated four times,
10 % of positions replaced by noise, targets the tokens shifted by one.
Tests that compare the two packages feed both the same numpy batch.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import resolve_device
from repro_torch.models.gnn.common import (
    GraphBatch, molecule_batch, random_graph_batch,
)


def step_generator(step: int, seed: int = 0) -> torch.Generator:
    """The CPU generator of batch ``step`` of stream ``seed``."""
    return torch.Generator(device="cpu").manual_seed(
        (seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF))


def lm_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0,
             device=None) -> dict:
    """Markov-ish synthetic token stream, structured enough that the loss
    falls: {"tokens", "targets"}, each (batch, seq - 1) int32."""
    dev = resolve_device(device)
    gen = step_generator(step, seed)
    base = torch.randint(0, vocab, (batch, (seq + 3) // 4), generator=gen)
    tokens = base.repeat_interleave(4, dim=1)[:, :seq]   # local repetition
    noise = torch.randint(0, vocab, (batch, seq), generator=gen)
    flip = torch.rand((batch, seq), generator=gen) < 0.1
    tokens = torch.where(flip, noise, tokens).to(torch.int32).to(dev)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}


def recsys_batch(step: int, batch: int, n_sparse: int, vocab: int,
                 n_dense: int = 13, bag: int = 1, seed: int = 0,
                 device=None) -> dict:
    """Click-through batch: {"sparse_idx" (batch, n_sparse, bag) int32
    below ``vocab``, "dense_feats" (batch, n_dense), "labels" (batch,)
    in {0, 1}}, the labels correlated with a planted linear signal."""
    dev = resolve_device(device)
    gen = step_generator(step, seed)
    sparse = torch.randint(0, vocab, (batch, n_sparse, bag), generator=gen,
                           dtype=torch.int32)
    dense = torch.randn((batch, n_dense), generator=gen)
    signal = dense[:, 0] + 0.1 * (sparse[:, 0, 0] % 7).float()
    labels = (signal + 0.5 * torch.randn((batch,), generator=gen) > 0) \
        .float()
    return {"sparse_idx": sparse.to(dev), "dense_feats": dense.to(dev),
            "labels": labels.to(dev)}


def molecule_train_batch(step: int, batch: int, nodes: int, edges: int,
                         d_feat: int, seed: int = 0,
                         device=None) -> GraphBatch:
    return molecule_batch(step_generator(step, seed), batch, nodes, edges,
                          d_feat, device=device)


def node_classification_batch(step: int, n_nodes: int, n_edges: int,
                              d_feat: int, n_classes: int = 8,
                              seed: int = 0, device=None) -> GraphBatch:
    return random_graph_batch(step_generator(step, seed), n_nodes, n_edges,
                              d_feat, n_classes=n_classes, device=device)


def grid_weather_batch(step: int, n_grid: int, n_vars: int, seed: int = 0,
                       device=None) -> dict:
    """{"grid_feats" (n_grid, n_vars), "target"}: the target is the state
    rolled by one grid row, scaled by 0.9, plus 0.1 noise (synthetic
    advection)."""
    dev = resolve_device(device)
    gen = step_generator(step, seed)
    state = torch.randn((n_grid, n_vars), generator=gen)
    target = torch.roll(state, 1, dims=0) * 0.9 \
        + 0.1 * torch.randn((n_grid, n_vars), generator=gen)
    return {"grid_feats": state.to(dev), "target": target.to(dev)}
