"""Carry instances and results between the two packages through numpy.

``instance_from_numpy`` builds the port's instance from another package's
instance arrays (``np.asarray`` of each leaf) and ``result_to_numpy`` turns
a port result into numpy arrays, so tests can run both packages on the
same instance without this package importing the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import MulticutInstance, resolve_device
from repro_torch.core.solver import SolveResult

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
