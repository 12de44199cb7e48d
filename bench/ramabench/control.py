"""The controls of the judge: answers that the limits have to fail.

* :func:`reference_in_place` puts the reference in the program's place,
  computed in bfloat16 (the precision below the float32 that the
  configurations state): ``control_bf16`` answers every instance of a
  run's plan, and the judge reads them as it reads the program's.
* :func:`bf16_costs` gives the program the plan's costs rounded to
  bfloat16, the step a change that stored costs in half the bytes would
  take; :func:`ramabench.harness.run_cell` takes them as ``cost``.

* :func:`planted` breaks the program underneath, from outside it, in a
  way that leaves every answer a sound partition: ``mp_unchanged``, a
  message passing that returns its costs unchanged and the trivial
  bound; ``no_triangles``, a separation that returns no valid triangle.

``bench/tools/readings.py`` reads them at a cell's own size on the card;
``bench/tests/test_ramabench_control.py`` and
``bench/tests/test_ramabench_faults.py`` at a size a CPU test holds.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

from ramabench import manifest, traffic as traffic_gen


def reference_in_place(config: dict, traffic: dict, seed: int,
                       limits: dict, max_neg: int = 256) -> dict:
    """Name -> value of each number the limits name, over the control's
    answers to every instance of the plan (counts summed, others at their
    worst)."""
    ref = manifest.reference(config["reference"])
    plan = traffic_gen.make_plan(config, traffic, seed, max_neg)
    values = {k: 0.0 for k in limits}
    for inst in plan.host:
        nums = ref.judge(inst, ref.control_bf16(inst))
        nums.pop("recount", None)
        for k in limits:
            if k in ("cycle_faults", "tri_inv"):
                continue        # the control runs no separation
            v = nums.get(k, math.inf)
            values[k] = values[k] + v if k.endswith("faults") else \
                max(values[k], v)
    return values


def bf16_costs(config: dict, traffic: dict, seed: int,
               max_neg: int = 256) -> dict:
    """Pool index -> the instance's costs rounded to bfloat16."""
    ref = manifest.reference(config["reference"])
    plan = traffic_gen.make_plan(config, traffic, seed, max_neg)
    return {i: ref.to_bf16(h.cost) for i, h in enumerate(plan.host)}


def fails(values: dict, limits: dict) -> bool:
    return any(values[k] > limits[k] for k in limits if k in values)


FAULTS = ("mp_unchanged", "no_triangles")


def _mp_unchanged(orig):
    def mp_phase(cost, edge_valid, tri, tri_valid, iters):
        import torch
        kept = torch.where(edge_valid, cost, torch.zeros_like(cost))
        return None, cost + 0.0, torch.clamp(kept, max=0.0).sum()
    return mp_phase


def _no_triangles(orig):
    def separate(*args, **kw):
        import torch
        sep = orig(*args, **kw)
        tri = sep.triangles
        return sep._replace(triangles=tri._replace(
            valid=torch.zeros_like(tri.valid)))
    return separate


@contextmanager
def planted(fault: str):
    """The program with ``fault`` planted for the duration (the solve
    registry is cleared on the way in and out, so that its entries
    resolve the broken functions)."""
    from repro_torch import api
    from repro_torch.core import solver
    from repro_torch.kernels.triangle_mp import ops
    targets = {"mp_unchanged": [(ops, "mp_phase", _mp_unchanged),
                                (solver, "mp_phase_per_edge",
                                 _mp_unchanged)],
               "no_triangles": [(solver, "separate", _no_triangles)]}
    undo = []
    api.clear_cache()
    try:
        for module, name, make in targets[fault]:
            orig = getattr(module, name)
            undo.append((module, name, orig))
            setattr(module, name, make(orig))
        yield
    finally:
        for module, name, orig in reversed(undo):
            setattr(module, name, orig)
        api.clear_cache()
