"""Carry instances, results and weights between the two packages through
numpy.

``instance_from_numpy`` builds the port's instance from another package's
instance arrays (``np.asarray`` of each leaf), ``result_to_numpy`` turns
a port result into numpy arrays, and ``transformer_params_from_numpy``,
``gnn_params_from_numpy`` and ``recsys_params_from_numpy`` take a
parameter tree, so tests can run both packages on the same inputs without
this package importing the other.

The GNN and recsys trees are carried over by name, not by position:
``jax.tree`` sorts dict keys while the port's trees keep the order its
``init_params`` writes them in, so each dict is rebuilt in that order
from its keys (a missing or extra key raises) and each list item by
item.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import MulticutInstance, resolve_device
from repro_torch.core.solver import SolveResult
from repro_torch.models import transformer as tfm

_DTYPES = (np.int32, np.int32, np.float32, np.bool_, np.bool_)


def instance_from_numpy(u, v, cost, edge_valid, node_valid,
                        device=None) -> MulticutInstance:
    """The port's instance from padded instance arrays, with the
    reference's dtypes (int32 ids, float32 costs, bool masks)."""
    dev = resolve_device(device)
    arrs = (u, v, cost, edge_valid, node_valid)
    return MulticutInstance(*(
        torch.from_numpy(np.array(a, dtype=dt, copy=True))
        .to(dev) for a, dt in zip(arrs, _DTYPES)))


def result_to_numpy(res: SolveResult) -> SolveResult:
    """A result with every leaf a numpy array on the host."""
    return SolveResult(*(t.detach().cpu().numpy() for t in res))


def transformer_params_from_numpy(tree, cfg: tfm.TransformerConfig,
                                  device=None,
                                  masters: bool = False) -> tfm.Params:
    """The port's transformer params from a JAX ``init_params`` tree
    (``{"embed", "layers": {...}, "final_norm", "lm_head"}``, layer
    leaves stacked on a leading L axis, MoE's ``router`` (L, d, E) and
    expert weights (L, E, d, ff) / (L, E, ff, d) among them; any
    array-likes), stored as
    :func:`repro_torch.models.transformer.init_params` stores them: matmul
    weights rounded to ``cfg.dtype`` (the cast the JAX model makes at each
    use), norms in ``cfg.param_dtype``; with ``masters`` every leaf in
    ``cfg.param_dtype`` (the training layout, the JAX tree's own)."""
    dev = resolve_device(device)

    def leaf(name, a):
        t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
        return t.to(device=dev, dtype=tfm._store_dtype(cfg, name, masters))

    out = {k: leaf(k, a) for k, a in tree.items() if k != "layers"}
    out["layers"] = {k: leaf(k, a) for k, a in tree["layers"].items()}
    return out


# The port's key order of each parameter tree: a dict maps a key to the
# spec of its value, a 1-tuple holds the spec of every item of a list,
# _MLP is an ``mlp_init`` block, None an array (or graphcast's None
# ``mesh_pos``).
_MLP = {"w": (None,), "b": (None,)}
_GNET = ({"edge": _MLP, "node": _MLP},)
_GNN_SPECS = {
    "egnn": {"embed": _MLP,
             "layers": ({"phi_e": _MLP, "phi_x": _MLP, "phi_h": _MLP},),
             "readout": _MLP},
    "dimenet": {"embed_node": _MLP, "embed_edge": _MLP, "rbf_proj": _MLP,
                "readout": _MLP,
                "blocks": ({"w_sbf": None, "w_bil": None, "msg_kj": _MLP,
                            "msg_ji": _MLP, "update": _MLP, "out": _MLP},)},
    "mace": {"embed": _MLP,
             "layers": ({"radial": _MLP, "mix0": None, "mix1": None,
                         "mix2": None, "corr_w0": None, "corr_w1": None,
                         "corr_w2": None, "update0": _MLP},),
             "readout": _MLP},
    "graphcast": {"grid_enc": _MLP, "mesh_init": _MLP, "g2m_edge": _MLP,
                  "g2m_node": _MLP, "layers": _GNET, "m2g_edge": _MLP,
                  "m2g_node": _MLP, "grid_dec": _MLP, "mesh_pos": None},
    "graphcast_processor": {"enc": _MLP, "layers": _GNET, "dec": _MLP},
    "partitioned": {"w_tri": None, "w_upd": None},
}
_RECSYS_SPEC = {"tables": None, "wide_tables": None,
                     "wide_dense": None, "mlp_w": (None,),
                     "mlp_b": (None,), "bias": None}


def _by_name(tree, spec, dev: torch.device):
    """``tree`` (nested dicts and lists of array-likes) as float32
    tensors on ``dev``, each dict in ``spec``'s key order."""
    if isinstance(spec, dict):
        if set(tree) != set(spec):
            raise KeyError(f"parameter keys {sorted(tree)} != the port's "
                           f"{sorted(spec)}")
        return {k: _by_name(tree[k], sub, dev)
                for k, sub in spec.items()}
    if isinstance(spec, tuple):
        return [_by_name(t, spec[0], dev) for t in tree]
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree, dtype=np.float32,
                                     copy=True)).to(dev)


def gnn_params_from_numpy(tree, kind: str, device=None) -> dict:
    """The port's GNN params from a JAX ``init_params`` tree of ``kind``
    (``egnn``, ``dimenet``, ``mace``, ``graphcast`` for the native
    weather model, ``graphcast_processor``, ``partitioned`` for the
    owner-partitioned block's ``{"w_tri", "w_upd"}``). A registry tree
    (``GNNArch.init_params``: ``{"trunk", "head"?}``) takes the arch's
    kind; its graphcast trunk is the processor."""
    dev = resolve_device(device)
    if "trunk" in tree:
        trunk = "graphcast_processor" if kind == "graphcast" else kind
        spec = {"trunk": _GNN_SPECS[trunk]}
        if "head" in tree:
            spec["head"] = None
        return _by_name(tree, spec, dev)
    return _by_name(tree, _GNN_SPECS[kind], dev)


def recsys_params_from_numpy(tree, device=None) -> dict:
    """The port's wide-deep params from the JAX ``recsys.init_params``
    tree."""
    return _by_name(tree, _RECSYS_SPEC, resolve_device(device))
