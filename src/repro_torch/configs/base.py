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
the order of the step's positional arguments; ``abstract_inputs`` gives
them as fake tensors.

Each family also carries the reference's plans for the production meshes
(``repro_torch.launch.mesh``): ``for_mesh(mesh)`` adapts the config to a
mesh (an LM's activation plan, MoE dispatch groups and expert fallback;
a GNN's graph-partition axes and bf16 compute dtype), and
``state_shardings(mesh, shape)`` / ``input_shardings(mesh, shape)`` give
a :class:`repro_torch.sharding.Sharding` for every state and input leaf.
The abstract state (``abstract_params``, ``abstract_opt``,
``abstract_cache``) is made under ``FakeTensorMode``: the shapes and
dtypes the init functions make, with no memory and no random draws.
Placed as DTensors, state and inputs run the same step functions on a
mesh (``repro_torch.launch.dryrun`` traces every cell so).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import dimenet as dn, egnn as eg, mace as mc
from repro_torch.models.gnn import graphcast as gc
from repro_torch.models.gnn.common import GraphBatch, scatter_rows, \
    set_act_axes
from repro_torch.sharding import (
    P, Sharding, axis_sizes, dp_axes, filter_axes, is_dtensor, named,
    prod_axes,
)
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import (
    OptimizerConfig, OptState, apply_update, init_opt_state,
)
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str     # train | prefill | decode | serve | retrieval | solver ...
    dims: dict


class InputSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def fake_mode():
    """The active ``FakeTensorMode``'s context (a no-op), or a new one:
    abstract state is made under it, shapes and dtypes with no memory."""
    import contextlib
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    if any(isinstance(m, FakeTensorMode)
           for m in _get_current_dispatch_mode_stack()):
        return contextlib.nullcontext()
    return FakeTensorMode()


def _abstract(specs: dict) -> dict:
    """Fake tensors of a dict of :class:`InputSpec`."""
    with fake_mode():
        return {k: torch.empty(v.shape, dtype=v.dtype)
                for k, v in specs.items()}


def _split_microbatches(x, k: int) -> list:
    """``k`` microbatches of a batch x (B, ...): the reference's
    consecutive slices of the global batch for a plain tensor; for a
    DTensor, consecutive slices of each rank's local rows, so every
    microbatch is sharded as the batch is. The microbatches partition the
    rows either way, so their mean loss and mean gradients are the whole
    batch's (in another order of adds)."""
    if not is_dtensor(x):
        return list(x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:])))
    from torch.distributed.tensor import DTensor
    loc = x.to_local()
    m = loc.shape[0] // k
    assert m * k == loc.shape[0], (loc.shape, k)
    return [DTensor.from_local(loc[i * m:(i + 1) * m], x.device_mesh,
                               x.placements, run_check=False)
            for i in range(k)]


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

    def for_mesh(self, mesh) -> "LMArch":
        """Adapt the config's mesh-axis references to ``mesh``: drop the
        pod axis on a single pod, set the MoE dispatch group count to the
        data-parallel degree, fall back from expert to ffn sharding when
        n_experts does not divide the model axis. The reference's
        per-decode-shape ``cache_pspecs`` have no counterpart: the cache is
        placed by :meth:`kv_pspec` and updated in place, which keeps its
        placements."""
        cfg = self.cfg
        updates = {}
        if cfg.act_sharding is not None:
            updates["act_sharding"] = tuple(
                filter_axes(mesh, P(*cfg.act_sharding)))
        if cfg.moe:
            updates["moe_groups"] = prod_axes(mesh, dp_axes(mesh))
            updates["moe_shard_experts"] = (
                cfg.n_experts % axis_sizes(mesh).get("model", 1) == 0)
        return dataclasses.replace(self, **(
            {"cfg": dataclasses.replace(cfg, **updates)} if updates else {}))

    # --- abstract state: fake tensors, no memory, no RNG draws ----------
    def abstract_params(self):
        """The training layout (every leaf in ``param_dtype``, as the
        reference's params), which every dry-run cell holds."""
        with fake_mode():
            return tfm.init_params(self.cfg, torch.Generator(), "cpu",
                                   masters=True)

    def abstract_opt(self, params=None):
        """``init_opt_state`` of ``params`` (DTensors keep their
        placements), by default of :meth:`abstract_params`."""
        with fake_mode():
            return init_opt_state(
                self.abstract_params() if params is None else params,
                state_dtype=self.opt_state_dtype)

    def abstract_cache(self, shape: ShapeCell):
        d = shape.dims
        with fake_mode():
            return tfm.init_kv_cache(self.cfg, d["global_batch"],
                                     d["seq_len"], "cpu")

    def input_specs(self, shape: ShapeCell) -> dict:
        d = shape.dims
        B, S = d["global_batch"], d["seq_len"]
        tok = InputSpec((B, S), torch.int32)
        if shape.kind == "train":
            return {"tokens": tok, "targets": tok}
        if shape.kind == "prefill":
            return {"tokens": tok}
        if shape.kind == "decode":
            return {"token": InputSpec((B,), torch.int32),
                    "cache_len": InputSpec((), torch.int32)}
        raise ValueError(shape.kind)

    def abstract_inputs(self, shape: ShapeCell) -> dict:
        return _abstract(self.input_specs(shape))

    # --- shardings ------------------------------------------------------
    def param_pspecs(self):
        return tfm.param_pspecs(self.cfg)

    def microbatches(self, global_batch: int, mesh=None) -> tuple:
        """(microbatches, rows of each on a rank, data shards) of a train
        step over ``global_batch`` rows on ``mesh`` (None: one device).
        ``grad_accum`` when it divides the batch, else 1, as the
        reference; on a mesh the batch shards over the data axes when
        they divide it (:meth:`input_shardings`), and the count is lowered
        until it divides each rank's rows."""
        ga = self.grad_accum if self.grad_accum > 1 \
            and global_batch % self.grad_accum == 0 else 1
        n = 1 if mesh is None else prod_axes(mesh, dp_axes(mesh))
        shards = n if global_batch % n == 0 else 1
        rows = global_batch // shards
        while rows % ga:
            ga -= 1
        return ga, rows // ga, shards

    def state_shardings(self, mesh, shape: ShapeCell) -> dict:
        pp = filter_axes(mesh, self.param_pspecs())
        # MoE expert fallback: when n_experts does not divide the model
        # axis (grok-1: 8 experts on a 16-way axis), keep experts whole
        # and run plain tensor parallelism over the expert ffn dims
        if self.cfg.moe and \
                self.cfg.n_experts % axis_sizes(mesh).get("model", 1):
            dax = dp_axes(mesh) or None
            pp["layers"]["w_gate"] = P(None, None, dax, "model")
            pp["layers"]["w_up"] = P(None, None, dax, "model")
            pp["layers"]["w_down"] = P(None, None, "model", dax)
        out = {"params": named(mesh, pp)}
        if shape.kind == "train":
            out["opt"] = OptState(step=Sharding(mesh, P()),
                                  mu=named(mesh, pp), nu=named(mesh, pp))
        if shape.kind == "decode":
            kv = Sharding(mesh, self.kv_pspec(mesh, shape))
            out["cache"] = {"k": kv, "v": kv}
        return out

    def kv_pspec(self, mesh, shape: ShapeCell) -> P:
        """KV-cache plan (L, B, Hkv, S, hd): batch over the data axes and
        heads over the model axis when they divide; an axis that cannot
        be used there shards the SEQUENCE instead (decode-time context
        parallelism: the cache update writes one row in place and the
        attention reduces across the sequence shards)."""
        dp = dp_axes(mesh)
        msize = axis_sizes(mesh)["model"]
        B = shape.dims["global_batch"]
        S = shape.dims["seq_len"]
        bshard = dp if B % prod_axes(mesh, dp) == 0 else None
        hshard = "model" if self.cfg.n_kv_heads % msize == 0 else None
        seq_axes = []
        if bshard is None:
            seq_axes.extend(dp)
        if hshard is None:
            seq_axes.append("model")
        seq_axes = tuple(a for a in seq_axes
                         if S % prod_axes(mesh, tuple(seq_axes)) == 0) \
            or None
        if seq_axes and S % prod_axes(mesh, seq_axes) != 0:
            seq_axes = None
        return P(None, bshard, hshard, seq_axes, None)

    def input_shardings(self, mesh, shape: ShapeCell) -> dict:
        dp = dp_axes(mesh)
        B = shape.dims["global_batch"]
        bshard = dp if B % prod_axes(mesh, dp) == 0 else None
        if shape.kind in ("train", "prefill"):
            return {k: Sharding(mesh, P(bshard, None))
                    for k in self.input_specs(shape)}
        return {"token": Sharding(mesh, P(bshard)),
                "cache_len": Sharding(mesh, P())}

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
                k = self.microbatches(B, tokens.device_mesh
                                      if is_dtensor(tokens) else None)[0]
                tk = _split_microbatches(tokens, k)
                tg = _split_microbatches(targets, k)
                # accumulate in f32 unless the arch runs a reduced-
                # precision optimizer (grok-1's bf16 posture)
                acc_dt = self.opt_state_dtype or torch.float32
                l = 0.0
                grads = tree_map(lambda p: torch.zeros_like(
                    p, dtype=acc_dt, memory_format=torch.contiguous_format),
                    params)
                for t, g in zip(tk, tg):
                    li, gi = value_and_grad(loss, params, t, g)
                    l = l + li
                    grads = tree_map(lambda a, g: a + g.to(acc_dt), grads,
                                     gi)
                    del gi
                l = l / k
                grads = tree_map(lambda g, p: (g / k).to(p.dtype), grads,
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
    shard_axes: tuple | None = None   # leading-dim mesh axes (per mesh)
    compute_dtype: Any = None         # bf16 on a mesh (set per mesh)

    @property
    def shapes(self):
        return GNN_SHAPES

    def for_mesh(self, mesh) -> "GNNArch":
        """Graph-partition data parallelism: node and edge hidden states
        shard their leading dim over the whole mesh, and the trunk computes
        in bf16 (halving the per-layer all-gathered node matrices that
        dominate the full-graph cells' memory)."""
        return dataclasses.replace(self, shard_axes=tuple(axis_sizes(mesh)),
                                   compute_dtype=torch.bfloat16)

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

    def abstract_params(self, shape: ShapeCell) -> dict:
        with fake_mode():
            return self.init_params(shape, torch.Generator())

    def abstract_opt(self, shape: ShapeCell, params=None):
        with fake_mode():
            return init_opt_state(self.abstract_params(shape)
                                  if params is None else params)

    def abstract_inputs(self, shape: ShapeCell) -> dict:
        return _abstract(self.input_specs(shape))

    def state_shardings(self, mesh, shape: ShapeCell) -> dict:
        """GNN params are small: replicated, and the optimizer state
        likewise."""
        with fake_mode():
            rep = tree_map(lambda _: Sharding(mesh, P()),
                           self.abstract_params(shape))
        return {"params": rep,
                "opt": OptState(step=Sharding(mesh, P()), mu=rep, nu=rep)}

    def input_shardings(self, mesh, shape: ShapeCell) -> dict:
        """Node and edge arrays shard their leading dim over every mesh
        axis when it divides (graph-partition data parallelism), else over
        the data axes when they divide, else stay whole."""
        dp = dp_axes(mesh)
        ndp = prod_axes(mesh, dp)
        all_ax = tuple(axis_sizes(mesh))
        nall = prod_axes(mesh, all_ax)

        def lead(n):
            if n % nall == 0:
                return all_ax
            if n % ndp == 0:
                return dp
            return None

        out = {}
        for k, v in self.input_specs(shape).items():
            if not v.shape:
                out[k] = Sharding(mesh, P())
            else:
                out[k] = Sharding(mesh, P(lead(v.shape[0]),
                                          *([None] * (len(v.shape) - 1))))
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

        compute_dtype = self.compute_dtype

        def build_graph(b):
            nodes = b["nodes"]
            pos = b.get("positions")
            if pos is None:
                pos = torch.zeros((nodes.shape[0], 3), device=nodes.device)
            if compute_dtype is not None:
                nodes = nodes.to(compute_dtype)
            return GraphBatch(
                nodes=nodes, edges_src=b["edges_src"],
                edges_dst=b["edges_dst"],
                edge_feat=torch.zeros((E, 1), dtype=nodes.dtype,
                                      device=nodes.device),
                node_mask=b["node_mask"], edge_mask=b["edge_mask"],
                graph_ids=b["graph_ids"], n_graphs=G,
                positions=pos, labels=b.get("labels_f"))

        shard_axes = self.shard_axes

        def loss(params, b):
            set_act_axes(shard_axes)   # trace-time switch; None = off
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
                    e = scatter_rows(ne, b["graph_ids"], G)
                return torch.mean((e - b["labels_f"]) ** 2)
            # node classification with the trainable head
            h = node_repr(params["trunk"], g, b)
            logits = h.to(params["head"].dtype) @ params["head"]
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

    def abstract_params(self) -> dict:
        with fake_mode():
            return rs.init_params(self.cfg, torch.Generator())

    def abstract_opt(self, params=None):
        with fake_mode():
            return init_opt_state(self.abstract_params() if params is None
                                  else params)

    def abstract_inputs(self, shape: ShapeCell) -> dict:
        return _abstract(self.input_specs(shape))

    def param_pspecs(self):
        return rs.param_pspecs(self.cfg)

    def state_shardings(self, mesh, shape: ShapeCell) -> dict:
        pp = named(mesh, self.param_pspecs())
        out = {"params": pp}
        if shape.kind == "train":
            out["opt"] = OptState(step=Sharding(mesh, P()), mu=pp, nu=pp)
        return out

    def input_shardings(self, mesh, shape: ShapeCell) -> dict:
        """The batch over the data axes when they divide it; the
        retrieval candidates over every mesh axis (the candidate set is
        padded to a multiple of 512 for it), the query whole."""
        dp = dp_axes(mesh)
        out = {}
        for k, v in self.input_specs(shape).items():
            if shape.kind == "retrieval":
                out[k] = Sharding(mesh, P(tuple(axis_sizes(mesh)), None)
                                  if k == "cands" else P(None))
            else:
                B = v.shape[0]
                bshard = dp if B % prod_axes(mesh, dp) == 0 else None
                out[k] = Sharding(mesh, P(bshard,
                                          *([None] * (len(v.shape) - 1))))
        return out

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
