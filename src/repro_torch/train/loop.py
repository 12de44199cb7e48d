"""Training loop (port of the JAX package's ``train/loop.py``): a step
with gradient accumulation, optional int8 error-feedback compression
and the optimizer update, and ``train`` with checkpoint and
restart-from-latest.

The loop is restart-idempotent: the data pipeline is a pure function of
(seed, step), so crash, restore the latest checkpoint and continue
reproduces the same trajectory. The step runs eagerly (no
``torch.compile``); like the JAX step, which donates its inputs, it
updates ``params`` and the optimizer state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.train.checkpoint import (
    load_checkpoint, restore, save_checkpoint_async,
)
from repro_torch.train.compression import (
    fake_quantize_ef, init_error_buffers,
)
from repro_torch.train.optimizer import (
    OptimizerConfig, apply_update, init_opt_state,
)
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptimizerConfig = OptimizerConfig()
    grad_accum: int = 1
    compress_grads: bool = False
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    log_every: int = 10


def value_and_grad(loss_fn: Callable, params, *args):
    """(loss, grads) of ``loss_fn(params, *args)``, the loss detached and
    the grads a tree shaped like ``params`` (the ``jax.value_and_grad``
    of the first argument). ``params`` need not require grad."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(live)
    loss = loss_fn(tree_map(lambda _: next(it), params), *args)
    grads = iter(torch.autograd.grad(loss, live, materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _microbatch(batch, ga: int, i: int):
    return tree_map(lambda x: x.reshape((ga, -1) + tuple(x.shape[1:]))[i],
                    batch)


def make_train_step(loss_fn: Callable, cfg: TrainConfig):
    """loss_fn(params, batch) -> scalar. Returns step:
    (params, opt_state, err, batch) -> (params', opt_state', err',
    metrics), ``params`` and the optimizer state updated in place."""
    def step(params, opt_state, err, batch):
        if cfg.grad_accum > 1:
            # microbatch over the leading axis of every batch leaf
            loss = torch.zeros((), device=tree_leaves(params)[0].device)
            grads = tree_map(torch.zeros_like, params)
            for i in range(cfg.grad_accum):
                l, g = value_and_grad(loss_fn, params,
                                      _microbatch(batch, cfg.grad_accum, i))
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / cfg.grad_accum
            grads = tree_map(lambda g: g / cfg.grad_accum, grads)
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        if cfg.compress_grads:
            grads, err = fake_quantize_ef(grads, err)
        params, opt_state, om = apply_update(cfg.opt, params, grads,
                                             opt_state)
        return params, opt_state, err, {"loss": loss, **om}
    return step


def train(loss_fn: Callable, params, batch_fn: Callable[[int], Any],
          cfg: TrainConfig, num_steps: int, step_hook=None):
    """Run (or resume from ``cfg.ckpt_dir``'s latest checkpoint) training
    to ``num_steps``. ``batch_fn(step)`` must be deterministic. The
    caller's ``params`` are copied first. Returns (params, opt_state,
    history)."""
    params = tree_map(lambda p: p.detach().clone(), params)
    opt_state = init_opt_state(params)
    err = init_error_buffers(params) if cfg.compress_grads else \
        tree_map(lambda x: torch.zeros((), dtype=x.dtype, device=x.device),
                 params)
    start = 0
    if cfg.ckpt_dir is not None:
        tmpl = {"params": params, "opt": opt_state, "err": err}
        loaded, info = load_checkpoint(cfg.ckpt_dir, tmpl)
        if loaded is not None:
            state = restore(loaded, tmpl)
            params, opt_state, err = state["params"], state["opt"], \
                state["err"]
            start = info["step"]

    step_fn = make_train_step(loss_fn, cfg)
    history = []
    pending = None
    for step in range(start, num_steps):
        batch = batch_fn(step)
        params, opt_state, err, metrics = step_fn(params, opt_state, err,
                                                  batch)
        if step % cfg.log_every == 0 or step == num_steps - 1:
            history.append({"step": step,
                            **{k: float(v) for k, v in metrics.items()}})
        if cfg.ckpt_dir is not None and (step + 1) % cfg.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = save_checkpoint_async(
                cfg.ckpt_dir, step + 1,
                {"params": params, "opt": opt_state, "err": err})
        if step_hook is not None:
            step_hook(step, params, metrics)
    if pending is not None:
        pending.join()
    return params, opt_state, history
