"""Carry instances, results and weights between the two packages through
numpy.

``instance_from_numpy`` builds the port's instance from another package's
instance arrays (``np.asarray`` of each leaf), ``result_to_numpy`` turns
a port result into numpy arrays, and ``transformer_params_from_numpy``
takes a transformer parameter tree, so tests can run both packages on the
same inputs without this package importing the other.
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
