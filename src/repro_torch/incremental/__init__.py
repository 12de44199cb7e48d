"""repro_torch.incremental — warm-started re-solve on graph deltas (port of
``repro.incremental``).

* :class:`DeltaPatch` (:mod:`.patch`) — a padded COO patch (upsert/delete
  entries) with host-side validation mirroring ``make_instance``;
* :class:`DeltaState` (:mod:`.state`) — the carried (instance, live CSR,
  previous labels) triple threaded between ticks;
* :func:`solve_delta_device` (:mod:`.solve`) — applies the patch (CSR
  maintained by :func:`repro_torch.core.graph.splice_csr`, equal to a
  fresh ``build_csr``) and re-solves: exactly (equal to a cold solve of
  the patched instance bit for bit) or warm (untouched clusters stay
  contracted, round-0 separation restricted to the patch frontier).

The serving tier exposes this as sticky sessions
(:mod:`repro_torch.serve.session`); the cached entry points are
``repro_torch.api.solve_with_state`` / ``solve_delta``.
"""
from repro_torch.incremental.patch import (
    DeltaPatch, PatchInfo, apply_patch, apply_patch_host, make_patch,
    pad_patch,
)
from repro_torch.incremental.solve import (
    patch_frontier, solve_cold_device, solve_delta_device,
)
from repro_torch.incremental.state import DeltaState, init_delta_state

__all__ = [
    "DeltaPatch", "DeltaState", "PatchInfo", "apply_patch",
    "apply_patch_host", "init_delta_state", "make_patch", "pad_patch",
    "patch_frontier", "solve_cold_device", "solve_delta_device",
]
