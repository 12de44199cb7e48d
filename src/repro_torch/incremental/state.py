"""The carried delta-solve state: what one update tick hands the next.

Port of ``repro.incremental.state``. :class:`DeltaState` holds the padded
instance, its live all-edges CSR (so the next tick splices instead of
rebuilding) and the previous solution's labels (so a warm re-solve can
keep untouched clusters contracted). It is a NamedTuple of fixed-shape
tensors, which is what lets the serving tier stack many sessions' states
into one batched delta dispatch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.graph import CsrGraph, MulticutInstance, \
    csr_from_instance

__all__ = ["DeltaState", "init_delta_state"]


class DeltaState(NamedTuple):
    """Carried state between :func:`repro_torch.api.solve_delta` ticks."""
    instance: MulticutInstance  # current full (uncontracted) padded problem
    csr: CsrGraph               # live all-valid-edges CSR of ``instance``
    labels: torch.Tensor        # (N,) i32 previous solution (identity
                                # before the first solve)
    has_solution: torch.Tensor  # () bool: ``labels`` hold a real solution
    lower_bound: torch.Tensor   # () f32 best-known dual bound for
                                # ``instance``: the last exact/cold tick's,
                                # plus every warm patch's ``lb_slack``
                                # since (−inf before the first dual solve)


def init_delta_state(inst: MulticutInstance,
                     csr: CsrGraph | None = None) -> DeltaState:
    """Fresh state around an instance: identity labels, no solution yet
    (a warm first tick degrades to a cold solve). Builds the one CSR every
    later tick splices."""
    if csr is None:
        csr = csr_from_instance(inst)
    dev = inst.device
    return DeltaState(
        instance=inst, csr=csr,
        labels=torch.arange(inst.num_nodes, dtype=torch.int32, device=dev),
        has_solution=torch.tensor(False, device=dev),
        lower_bound=torch.tensor(float("-inf"), dtype=torch.float32,
                                 device=dev))
