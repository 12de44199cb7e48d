"""Architecture registry of the port (after the JAX package's
``configs/base.py``): every dense LM config, and the RAMA multicut config
(``configs/rama_multicut.py``), is a selectable arch with its shapes, its
steps and its analytic model FLOPs.

    arch = get_arch("gemma2-9b")
    prefill = arch.step_fn(arch.shapes["prefill_32k"])   # (params, tokens)
    decode = arch.step_fn(arch.shapes["decode_32k"])     # (params, cache,
                                                          #  token, cache_len)

Only ``prefill`` and ``decode`` steps exist; the train step, shardings and
abstract (``eval_shape``) state of the JAX registry have no counterpart on
one card without autograd (training: ROADMAP Queue 1 item 15). The GNN
and recsys families are not registered here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import transformer as tfm


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

    @property
    def shapes(self):
        return LM_SHAPES

    def step_fn(self, shape: ShapeCell, backend: str = "cuda") -> Callable:
        """The serving step of ``shape``: ``prefill_step(params, tokens)``
        -> logits (attention through ``backend``), or
        ``serve_step(params, cache, token, cache_len)`` -> (logits,
        cache)."""
        cfg = self.cfg
        if shape.kind == "prefill":
            def prefill_step(params, tokens):
                return tfm.forward(cfg, params, tokens, backend=backend)
            return prefill_step
        if shape.kind == "decode":
            def serve_step(params, cache, token, cache_len):
                return tfm.decode_step(cfg, params, token, cache, cache_len)
            return serve_step
        if shape.kind == "train":
            raise NotImplementedError(
                "the train step (loss_fn, the flash backward, the "
                "optimizer) is not ported yet (ROADMAP Queue 1 item 15)")
        raise ValueError(shape.kind)

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
