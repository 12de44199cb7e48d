"""Deterministic synthetic data (step -> batch), after the JAX package's
``data/synthetic.py``. Determinism in (seed, step) is what makes a
restored checkpoint resume the same trajectory.

Only the LM batch is ported; the recsys, molecule and weather batches come
with their model families. The port cannot reproduce the bits of
``jax.random``: ``lm_batch`` has the JAX batch's structure (random base
tokens repeated four times, 10 % of positions replaced by noise, targets
the tokens shifted by one) drawn from a ``torch.Generator`` seeded by
(seed, step), so its tokens differ from the JAX package's. Tests that
compare the two packages feed both the same numpy batch.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import resolve_device


def lm_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0,
             device=None) -> dict:
    """Markov-ish synthetic token stream, structured enough that the loss
    falls: {"tokens", "targets"}, each (batch, seq - 1) int32 on
    ``device`` (cuda by default)."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(
        (seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF))
    base = torch.randint(0, vocab, (batch, (seq + 3) // 4), generator=gen)
    tokens = base.repeat_interleave(4, dim=1)[:, :seq]   # local repetition
    noise = torch.randint(0, vocab, (batch, seq), generator=gen)
    flip = torch.rand((batch, seq), generator=gen) < 0.1
    tokens = torch.where(flip, noise, tokens).to(torch.int32).to(dev)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
