"""Optimizers (port of the JAX package's ``train/optimizer.py``): AdamW
and SGD-momentum, cosine / linear / constant schedules with warm-up,
global-norm clipping.

Optimizer state is a tree shaped like the params (``init_opt_state``,
optionally in a reduced ``state_dtype``, grok-1's bf16 posture). The
arithmetic follows the JAX functions op for op in the leaves' dtypes.
The schedule, the step and the metrics stay 0-dim tensors on the params'
device, so a step asks the host for nothing.

Differences from the JAX module: an update writes the new params and
moments into the given tensors (the port's counterpart of the JAX step
donating its buffers: on one card a second copy of a full-width model's
params and moments does not fit beside the first) and returns those
trees with a new ``OptState``; the global norm sums the leaves in the
tree's insertion order (``jax.tree.leaves`` sorts dict keys).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"   # cosine | linear | constant
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor          # 0-dim int32
    mu: Any
    nu: Any


def init_opt_state(params, state_dtype: torch.dtype | None = None
                   ) -> OptState:
    """Zero moments shaped like ``params`` (in ``state_dtype``, else each
    param's dtype) and step 0, on the params' device."""
    def z(p):       # zeros_like keeps a DTensor param's placements
        return torch.zeros_like(p, dtype=state_dtype or p.dtype,
                                memory_format=torch.contiguous_format)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(z, params), nu=tree_map(z, params))


def schedule_lr(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (0-dim, float32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "constant":
        decay = 1.0
    elif cfg.schedule == "linear":
        t = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
        decay = 1.0 - (1.0 - cfg.min_lr_frac) * t
    else:  # cosine
        t = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
            * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * decay


def _global_norm(grads) -> torch.Tensor:
    total = 0
    for g in tree_leaves(grads):
        total = total + g.float().square().sum()
    return torch.sqrt(total)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """Scale grads so the global norm is <= max_norm; max_norm <= 0
    disables clipping (the norm is still computed for metrics). Returns
    new grads and the norm."""
    gnorm = _global_norm(grads)
    if max_norm <= 0:
        return grads, gnorm
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def _leaves(params, grads, *trees):
    return zip(tree_leaves(params), tree_leaves(grads),
               *(tree_leaves(t) for t in trees))


def adamw_update(cfg: OptimizerConfig, params, grads, state: OptState):
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip > 0 \
        else None
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    with torch.no_grad():
        for p, g, m, v in _leaves(params, grads, state.mu, state.nu):
            if scale is not None:
                g = g * scale.to(g.dtype)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g.square())
            # reduced-precision state (grok-1) updates in its own dtype
            ct = torch.float32 if m.dtype == torch.float32 else m.dtype
            mhat = m.to(ct) / bc1.to(ct)
            vhat = v.to(ct) / bc2.to(ct)
            upd = mhat / (torch.sqrt(vhat) + torch.tensor(cfg.eps, dtype=ct))
            wd = torch.tensor(cfg.weight_decay, dtype=ct)
            p.copy_(p - lr.to(ct) * (upd + wd * p.to(ct)))
    return params, OptState(step=step, mu=state.mu, nu=state.nu), \
        {"lr": lr, "grad_norm": gnorm}


def sgd_update(cfg: OptimizerConfig, params, grads, state: OptState):
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    with torch.no_grad():
        for p, g, m in _leaves(params, grads, state.mu):
            m.copy_(0.9 * m + g)
            p.copy_(p - lr * m)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), \
        {"lr": lr, "grad_norm": gnorm}


def apply_update(cfg: OptimizerConfig, params, grads, state: OptState):
    """One optimizer step: writes the new params and moments into
    ``params`` and ``state`` and returns (params, state', metrics)."""
    if cfg.kind == "adamw":
        return adamw_update(cfg, params, grads, state)
    if cfg.kind == "sgd":
        return sgd_update(cfg, params, grads, state)
    raise ValueError(cfg.kind)
