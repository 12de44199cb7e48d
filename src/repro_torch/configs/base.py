"""Architecture registry of the port (after the JAX package's
``configs/base.py``): every LM config (dense and MoE), the GNN archs
(dimenet, egnn, mace, graphcast), the wide-deep recommender and the RAMA
multicut config (``configs/rama_multicut.py``) are selectable archs with
their shapes, their steps and their analytic model FLOPs.

    arch = get_arch("gemma2-9b")
    prefill = arch.step_fn(arch.shapes["prefill_32k"])   # (params, tokens)
    decode = arch.step_fn(arch.shapes["decode_32k"])     # (params, cache,
                                                          #  token, cache_len)
    train = arch.step_fn(arch.shapes["train_4k"])        # (params, opt,
                                                          #  tokens, targets)

The train step takes master params (``init_params(..., masters=True)``)
and an ``init_opt_state(params, state_dtype=arch.opt_state_dtype)``
state, and updates both in place. A GNN or recsys arch's
``input_specs(shape)`` gives the (shape, dtype) of each step input, in
the order of the step's positional arguments (the JAX registry's
``abstract_inputs``). The production meshes exist
(``repro_torch.launch.mesh``); the per-arch sharding plans, ``for_mesh``
(which sets a pod mesh's bf16 GNN compute dtype; the port's GNN trunks
compute in float32) and the abstract (``eval_shape``) state of the JAX
registry have no counterpart yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import dimenet as dn, egnn as eg, mace as mc
from repro_torch.models.gnn import graphcast as gc
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.sparse.segment_ops import scatter_sum
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import OptimizerConfig, apply_update
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str     # train | prefill | decode | serve | retrieval | solver ...
    dims: dict


class InputSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


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


# ===========================================================================
# GNN family
# ===========================================================================

GNN_SHAPES = {
    "full_graph_sm": ShapeCell("full_graph_sm", "train",
                               dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                                    n_classes=7, task="node_cls")),
    "minibatch_lg": ShapeCell("minibatch_lg", "train",
                              dict(n_nodes=196608, n_edges=212992, d_feat=602,
                                   n_classes=41, task="node_cls",
                                   n_seeds=1024)),
    "ogb_products": ShapeCell("ogb_products", "train",
                              dict(n_nodes=2449029, n_edges=61859140,
                                   d_feat=100, n_classes=47,
                                   task="node_cls")),
    "molecule": ShapeCell("molecule", "train",
                          dict(n_nodes=30, n_edges=64, batch=128, d_feat=16,
                               task="energy")),
}


@dataclasses.dataclass(frozen=True)
class GNNArch:
    id: str
    kind: str                    # dimenet | egnn | mace | graphcast
    cfg: Any
    opt: OptimizerConfig = OptimizerConfig()
    family: str = "gnn"
    tri_factor: int = 2          # triplets per edge cap (dimenet)

    @property
    def shapes(self):
        return GNN_SHAPES

    def _dims(self, shape: ShapeCell):
        d = dict(shape.dims)
        if shape.name == "molecule":
            d["N"] = d["n_nodes"] * d["batch"]
            d["E"] = d["n_edges"] * d["batch"]
            d["G"] = d["batch"]
        else:
            d["N"] = d["n_nodes"]
            d["E"] = d["n_edges"]
            d["G"] = 1
        # node/edge axes padded to multiples of 512 (the reference pads for
        # its largest mesh); kept so the shapes equal the reference's.
        # Padding is masked out numerically.
        pad = 512
        d["N"] = -(-d["N"] // pad) * pad
        d["E"] = -(-d["E"] // pad) * pad
        return d

    def _shape_cfg(self, shape: ShapeCell):
        """Model config with input width bound to the shape's d_feat."""
        if self.kind == "graphcast":
            return self.cfg  # processor mode takes d_in separately
        return dataclasses.replace(self.cfg, d_in=self._dims(shape)["d_feat"])

    def init_params(self, shape: ShapeCell, gen: torch.Generator) -> dict:
        """{"trunk", "head" (node classification)} on ``gen``'s device."""
        d = self._dims(shape)
        if self.kind == "graphcast":
            trunk = gc.init_processor_params(self.cfg, gen, d["d_feat"])
            d_repr = self.cfg.d_hidden
        else:
            cfg2 = self._shape_cfg(shape)
            mod = {"dimenet": dn, "egnn": eg, "mace": mc}[self.kind]
            trunk = mod.init_params(cfg2, gen)
            d_repr = cfg2.d_hidden
        out = {"trunk": trunk}
        if d["task"] == "node_cls":
            out["head"] = torch.randn((d_repr, d["n_classes"]), generator=gen,
                                      device=gen.device).mul_(0.02)
        return out

    def _node_repr_fn(self, shape: ShapeCell):
        cfg2 = self._shape_cfg(shape)
        kind = self.kind

        def fn(trunk, g, batch):
            if kind == "graphcast":
                return gc.processor_node_repr(
                    self.cfg, trunk, g.nodes, g.edges_src, g.edges_dst,
                    edge_mask=g.edge_mask)
            if kind == "egnn":
                return eg.node_repr(cfg2, trunk, g)
            if kind == "mace":
                return mc.node_repr(cfg2, trunk, g)
            return dn.node_repr(cfg2, trunk, g, batch["tri_kj"],
                                batch["tri_ji"], batch["tri_mask"])
        return fn

    def input_specs(self, shape: ShapeCell) -> dict:
        d = self._dims(shape)
        N, E, G = d["N"], d["E"], d["G"]
        f32, i32, b = torch.float32, torch.int32, torch.bool
        out = {
            "nodes": InputSpec((N, d["d_feat"]), f32),
            "edges_src": InputSpec((E,), i32),
            "edges_dst": InputSpec((E,), i32),
            "node_mask": InputSpec((N,), b),
            "edge_mask": InputSpec((E,), b),
            "graph_ids": InputSpec((N,), i32),
        }
        if d["task"] == "energy":
            out["labels_f"] = InputSpec((G,), f32)
        else:
            out["labels_i"] = InputSpec((N,), i32)
            out["label_mask"] = InputSpec((N,), b)
        if self.kind in ("dimenet", "egnn", "mace"):
            out["positions"] = InputSpec((N, 3), f32)
        if self.kind == "dimenet":
            T = self.tri_factor * E
            out["tri_kj"] = InputSpec((T,), i32)
            out["tri_ji"] = InputSpec((T,), i32)
            out["tri_mask"] = InputSpec((T,), b)
        return out

    def _loss(self, shape: ShapeCell):
        d = self._dims(shape)
        E, G = d["E"], d["G"]
        kind = self.kind
        cfg2 = self._shape_cfg(shape)
        node_repr = self._node_repr_fn(shape)

        def build_graph(b):
            nodes = b["nodes"]
            pos = b.get("positions")
            if pos is None:
                pos = torch.zeros((nodes.shape[0], 3), device=nodes.device)
            return GraphBatch(
                nodes=nodes, edges_src=b["edges_src"],
                edges_dst=b["edges_dst"],
                edge_feat=torch.zeros((E, 1), dtype=nodes.dtype,
                                      device=nodes.device),
                node_mask=b["node_mask"], edge_mask=b["edge_mask"],
                graph_ids=b["graph_ids"], n_graphs=G,
                positions=pos, labels=b.get("labels_f"))

        def loss(params, b):
            g = build_graph(b)
            if d["task"] == "energy":
                if kind == "dimenet":
                    e = dn.forward(cfg2, params["trunk"], g, b["tri_kj"],
                                   b["tri_ji"], b["tri_mask"])
                elif kind == "egnn":
                    e = eg.forward(cfg2, params["trunk"], g)[0]
                elif kind == "mace":
                    e = mc.forward(cfg2, params["trunk"], g)
                else:
                    h = node_repr(params["trunk"], g, b)
                    ne = h.mean(-1) * g.node_mask.to(h.dtype)
                    e = scatter_sum(ne, b["graph_ids"], G)
                return torch.mean((e - b["labels_f"]) ** 2)
            # node classification with the trainable head
            h = node_repr(params["trunk"], g, b)
            logits = h @ params["head"]
            logz = torch.logsumexp(logits, -1)
            tgt = logits.gather(-1, b["labels_i"].long()[:, None])[:, 0]
            lm = b["label_mask"].float()
            return ((logz - tgt) * lm).sum() / torch.clamp(lm.sum(), min=1.0)

        return loss

    def step_fn(self, shape: ShapeCell) -> Callable:
        """``train_step(params, opt_state, *inputs)`` (the inputs in
        :meth:`input_specs` order, or by name) -> (params, opt_state,
        {"loss", "lr", "grad_norm"}), updating both in place."""
        loss = self._loss(shape)
        opt_cfg = self.opt
        keys = list(self.input_specs(shape))

        def train_step(params, opt_state, *vals, **kw):
            batch = dict(zip(keys, vals)) if vals else kw
            l, grads = value_and_grad(loss, params, batch)
            params, opt_state, om = apply_update(opt_cfg, params, grads,
                                                 opt_state)
            return params, opt_state, {"loss": l, **om}
        return train_step

    def model_flops(self, shape: ShapeCell) -> float:
        d = self._dims(shape)
        N, E = d["N"], d["E"]
        if self.kind == "egnn":
            c = self.cfg.d_hidden
            return self.cfg.n_layers * (E * (8 * c * c) + N * (8 * c * c)) * 3
        if self.kind == "dimenet":
            c = self.cfg.d_hidden
            T = self.tri_factor * E
            per_block = T * (2 * self.cfg.n_bilinear * c * c) + E * 6 * c * c
            return self.cfg.n_blocks * per_block * 3
        if self.kind == "mace":
            c = self.cfg.d_hidden
            irr = 1 + 3 + 9
            return self.cfg.n_layers * (E * c * irr * 20
                                        + N * (3 * c * c * irr)) * 3
        # graphcast processor
        dh = self.cfg.d_hidden
        return self.cfg.n_layers * (E * 8 * dh * dh + N * 6 * dh * dh) * 3


# ===========================================================================
# Recsys family
# ===========================================================================

RECSYS_SHAPES = {
    "train_batch": ShapeCell("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeCell("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeCell("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}
RETRIEVAL_TOP_K = 128


@dataclasses.dataclass(frozen=True)
class RecsysArch:
    id: str
    cfg: rs.WideDeepConfig
    opt: OptimizerConfig = OptimizerConfig()
    family: str = "recsys"

    @property
    def shapes(self):
        return RECSYS_SHAPES

    def input_specs(self, shape: ShapeCell) -> dict:
        d = shape.dims
        B = d["batch"]
        F, bag = self.cfg.n_sparse, self.cfg.multi_hot
        if shape.kind == "retrieval":
            # the candidate set padded to a 512-multiple, as the
            # reference pads it; the caller fills the padding rows
            nc = -(-d["n_candidates"] // 512) * 512
            return {"query": InputSpec((self.cfg.cand_dim,), torch.float32),
                    "cands": InputSpec((nc, self.cfg.cand_dim),
                                       torch.float32)}
        out = {"sparse_idx": InputSpec((B, F, bag), torch.int32),
               "dense_feats": InputSpec((B, self.cfg.n_dense),
                                        torch.float32)}
        if shape.kind == "train":
            out["labels"] = InputSpec((B,), torch.float32)
        return out

    def step_fn(self, shape: ShapeCell) -> Callable:
        """``train_step(params, opt_state, sparse_idx, dense_feats,
        labels)`` -> (params, opt_state, metrics), updating both in place;
        ``serve_step(params, sparse_idx, dense_feats)`` -> logits;
        ``retrieval_step(query, cands)`` -> the top 128 (scores, int32
        indices)."""
        cfg, opt_cfg = self.cfg, self.opt
        if shape.kind == "train":
            def train_step(params, opt_state, sparse_idx, dense_feats,
                           labels):
                def loss(p):
                    return rs.loss_fn(cfg, p, sparse_idx, dense_feats, labels)
                l, grads = value_and_grad(loss, params)
                params, opt_state, om = apply_update(opt_cfg, params, grads,
                                                     opt_state)
                return params, opt_state, {"loss": l, **om}
            return train_step
        if shape.kind == "serve":
            def serve_step(params, sparse_idx, dense_feats):
                return rs.forward(cfg, params, sparse_idx, dense_feats)
            return serve_step
        if shape.kind == "retrieval":
            def retrieval_step(query, cands):
                vals, idx = torch.topk(rs.retrieval_score(query, cands),
                                       RETRIEVAL_TOP_K)
                return vals, idx.to(torch.int32)
            return retrieval_step
        raise ValueError(shape.kind)

    def model_flops(self, shape: ShapeCell) -> float:
        d = shape.dims
        cfg = self.cfg
        if shape.kind == "retrieval":
            return 2.0 * d["n_candidates"] * cfg.cand_dim
        B = d["batch"]
        deep_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
        dims = (deep_in,) + tuple(cfg.mlp_dims) + (1,)
        mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
        lookup = cfg.n_sparse * cfg.multi_hot * cfg.embed_dim * 2
        per_ex = mlp + lookup
        mult = 3.0 if shape.kind == "train" else 1.0
        return B * per_ex * mult
