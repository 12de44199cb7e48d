"""Plain PyTorch version of the triangle message-passing sweep (Alg. 2,
lines 8-13) — the oracle the CUDA kernel is held to, bit for bit.

Each step is separate torch ops (a product, then a difference), so no
multiply-add is fused; the kernel is compiled without FMA contraction to
give the same bits.
"""
from __future__ import annotations

import torch


def _mm(a, b, c):
    """Min-marginal of the first edge given triangle costs (a, b, c)."""
    s = b + c
    return a + torch.minimum(torch.minimum(b, c), s) \
        - torch.minimum(s, torch.zeros_like(s))


def mp_sweep_ref(t_cost: torch.Tensor) -> torch.Tensor:
    """t_cost: (..., 3) triangle subproblem costs. Returns swept costs after
    the fixed sequence e1:1/3, e2:1/2, e3:1, e1:1/2, e2:1, e1:1 — each
    min-marginal computed on the current costs (λ += γm ⇔ cost −= γm)."""
    a, b, c = t_cost[..., 0], t_cost[..., 1], t_cost[..., 2]
    a = a - (1.0 / 3.0) * _mm(a, b, c)
    b = b - (1.0 / 2.0) * _mm(b, a, c)
    c = c - 1.0 * _mm(c, a, b)
    a = a - (1.0 / 2.0) * _mm(a, b, c)
    b = b - 1.0 * _mm(b, a, c)
    a = a - 1.0 * _mm(a, b, c)
    return torch.stack([a, b, c], dim=-1)
