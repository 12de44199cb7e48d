"""Architecture registry of the port (after the JAX package's
``configs/base.py``): every LM config (dense and MoE), and the RAMA
multicut config (``configs/rama_multicut.py``), is a selectable arch with
its shapes, its steps and its analytic model FLOPs.

    arch = get_arch("gemma2-9b")
    prefill = arch.step_fn(arch.shapes["prefill_32k"])   # (params, tokens)
    decode = arch.step_fn(arch.shapes["decode_32k"])     # (params, cache,
                                                          #  token, cache_len)
    train = arch.step_fn(arch.shapes["train_4k"])        # (params, opt,
                                                          #  tokens, targets)

The train step takes master params (``init_params(..., masters=True)``)
and an ``init_opt_state(params, state_dtype=arch.opt_state_dtype)``
state, and updates both in place. The shardings, ``for_mesh`` and the
abstract (``eval_shape``) state of the JAX registry have no counterpart
on one card. The GNN and recsys families are not registered here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import transformer as tfm
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import OptimizerConfig, apply_update
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode | solver | mp | dist
    dims: dict


REGISTRY: dict[str, object] = {}


def register(arch):
    REGISTRY[arch.id] = arch
    return arch


def get_arch(arch_id: str):
    import repro_torch.configs  # noqa: F401  (triggers registration)
    return REGISTRY[arch_id]


LM_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train",
                          dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeCell("prefill_32k", "prefill",
                             dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeCell("decode_32k", "decode",
                            dict(seq_len=32768, global_batch=128)),
    "long_500k": ShapeCell("long_500k", "decode",
                           dict(seq_len=524288, global_batch=1)),
}


@dataclasses.dataclass(frozen=True)
class LMArch:
    id: str
    cfg: tfm.TransformerConfig
    opt: OptimizerConfig = OptimizerConfig()
    opt_state_dtype: torch.dtype | None = None
    family: str = "lm"
    # microbatches per train step (when they divide the batch)
    grad_accum: int = 4

    @property
    def shapes(self):
        return LM_SHAPES

    def step_fn(self, shape: ShapeCell, backend: str = "cuda") -> Callable:
        """The step of ``shape``, attention through ``backend``:
        ``train_step(params, opt_state, tokens, targets)`` -> (params,
        opt_state, {"loss", "lr", "grad_norm"}), ``prefill_step(params,
        tokens)`` -> logits, or ``serve_step(params, cache, token,
        cache_len)`` -> (logits, cache)."""
        cfg = self.cfg
        if shape.kind == "train":
            return self._train_step(backend)
        if shape.kind == "prefill":
            def prefill_step(params, tokens):
                return tfm.forward(cfg, params, tokens, backend=backend)
            return prefill_step
        if shape.kind == "decode":
            def serve_step(params, cache, token, cache_len):
                return tfm.decode_step(cfg, params, token, cache, cache_len)
            return serve_step
        raise ValueError(shape.kind)

    def _train_step(self, backend: str) -> Callable:
        cfg, opt_cfg, ga = self.cfg, self.opt, self.grad_accum

        def loss(p, tokens, targets):
            return tfm.loss_fn(cfg, p, tokens, targets, backend=backend)

        def train_step(params, opt_state, tokens, targets):
            B = tokens.shape[0]
            if ga > 1 and B % ga == 0:
                tk = tokens.reshape(ga, B // ga, -1)
                tg = targets.reshape(ga, B // ga, -1)
                # accumulate in f32 unless the arch runs a reduced-
                # precision optimizer (grok-1's bf16 posture)
                acc_dt = self.opt_state_dtype or torch.float32
                l = torch.zeros((), device=tokens.device)
                grads = tree_map(lambda p: torch.zeros(
                    p.shape, dtype=acc_dt, device=p.device), params)
                for i in range(ga):
                    li, gi = value_and_grad(loss, params, tk[i], tg[i])
                    l = l + li
                    grads = tree_map(lambda a, g: a + g.to(acc_dt), grads,
                                     gi)
                    del gi
                l = l / ga
                grads = tree_map(lambda g, p: (g / ga).to(p.dtype), grads,
                                 params)
            else:
                l, grads = value_and_grad(loss, params, tokens, targets)
            params, opt_state, om = apply_update(opt_cfg, params, grads,
                                                 opt_state)
            return params, opt_state, {"loss": l, **om}
        return train_step

    def model_flops(self, shape: ShapeCell) -> float:
        """MODEL_FLOPS = 6·N_active·D for train, 2·N_active·D for inference."""
        d = shape.dims
        n_act = self.cfg.active_params_count
        if shape.kind == "train":
            return 6.0 * n_act * d["seq_len"] * d["global_batch"]
        if shape.kind == "prefill":
            return 2.0 * n_act * d["seq_len"] * d["global_batch"]
        # decode: one token per sequence + attention over the cache
        B = d["global_batch"]
        attn = (2.0 * self.cfg.n_layers * self.cfg.n_heads * self.cfg.hd
                * d["seq_len"] * 2) * B
        return 2.0 * n_act * B + attn
