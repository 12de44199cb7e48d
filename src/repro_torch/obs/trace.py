"""Structured solver telemetry: a :class:`SolveTrace` of per-round rows
written inside the round loop with no host sync (port of
``repro.obs.trace``).

The reference carries the trace in its ``lax.while_loop`` carry. The port
runs its round loop eagerly, so a trace is a NamedTuple of tensors on the
solve's device, preallocated by :func:`init_trace` and written in place by
:func:`trace_set_round`: each write is a device op (a row copy, a clamp),
never a read back to the host. Tracing is strictly additive: the traced
solve runs the untraced solve's ops plus reads of what each round already
produced, so labels, objective and bound are bit-identical.

Shape convention: per-round leaves are padded to ``(max_rounds,)`` (or
``(max_rounds, shards)`` for per-shard leaves), with padding chosen so
:func:`summarize` can mask it out (``rounds`` says how many rows are
live). The per-shard leaves have ``shards == 1`` on the unsharded paths,
so the trace has the reference's structure whatever path produced it.

:func:`summarize` is the host-side view, and the only place that calls
``float()``/``int()`` on trace leaves.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.graph import resolve_device

__all__ = ["SolveTrace", "init_trace", "trace_set_round", "summarize"]

# Padding sentinels (masked out by `summarize` via `rounds`): +inf for
# minimised quantities keeps best-so-far scans monotone; -inf for the LB.
_PAD_OBJ = float("inf")
_PAD_LB = float("-inf")


class SolveTrace(NamedTuple):
    """Per-round solver telemetry. All leaves are tensors on the solve's
    device; rows ``>= rounds`` are padding. ``shard_*`` leaves have a
    trailing shard axis (size 1 on unsharded paths).

    - ``rounds``: () i32 — number of live rows.
    - ``lower_bound``: (R,) f32 — dual bound after the round's MP phase.
    - ``objective``: (R,) f32 — primal objective of the labelling held
      after the round's contraction.
    - ``n_cycles``: (R,) i32 — conflicted cycles found by separation.
    - ``n_contracted``: (R,) i32 — edges contracted this round.
    - ``n_clusters``: (R,) i32 — clusters remaining after the round.
    - ``mp_improvement``: (R,) f32 — LB gain of the MP phase over the
      trivial bound Σ min(0, cost) on the round's pre-MP costs.
    - ``shard_edges``: (R, S) i32 — live edges owned per shard.
    - ``shard_topk``: (R, S) i32 — repulsive-anchor slots won per shard.
    - ``shard_halo``: (R, S) i32 — triangle-slot edge references landing
      on each shard.
    """

    rounds: torch.Tensor
    lower_bound: torch.Tensor
    objective: torch.Tensor
    n_cycles: torch.Tensor
    n_contracted: torch.Tensor
    n_clusters: torch.Tensor
    mp_improvement: torch.Tensor
    shard_edges: torch.Tensor
    shard_topk: torch.Tensor
    shard_halo: torch.Tensor


def init_trace(max_rounds: int, shards: int = 1, device=None) -> SolveTrace:
    """An all-padding trace with room for ``max_rounds`` rows on
    ``device``: ``cuda`` unless the caller names another (the solver
    passes its instance's); with no card and no device this raises."""
    device = resolve_device(device)
    r = max(int(max_rounds), 1)
    s = max(int(shards), 1)
    f = dict(dtype=torch.float32, device=device)
    i = dict(dtype=torch.int32, device=device)
    return SolveTrace(
        rounds=torch.zeros((), **i),
        lower_bound=torch.full((r,), _PAD_LB, **f),
        objective=torch.full((r,), _PAD_OBJ, **f),
        n_cycles=torch.zeros((r,), **i),
        n_contracted=torch.zeros((r,), **i),
        n_clusters=torch.zeros((r,), **i),
        mp_improvement=torch.zeros((r,), **f),
        shard_edges=torch.zeros((r, s), **i),
        shard_topk=torch.zeros((r, s), **i),
        shard_halo=torch.zeros((r, s), **i),
    )


def trace_set_round(trace: SolveTrace, r: int, *, lower_bound=None,
                    objective=None, n_cycles=None, n_contracted=None,
                    n_clusters=None, mp_improvement=None, shard_edges=None,
                    shard_topk=None, shard_halo=None) -> SolveTrace:
    """Write row ``r`` (a Python int) of the per-round leaves in place and
    raise ``rounds`` to at least ``r + 1``; returns the same trace. Fields
    left as None keep their padding (the dual phase e.g. has no
    contraction to report). Values may be tensors on the trace's device
    or Python numbers and lists; no write reads anything back to the
    host."""
    updates = dict(lower_bound=lower_bound, objective=objective,
                   n_cycles=n_cycles, n_contracted=n_contracted,
                   n_clusters=n_clusters, mp_improvement=mp_improvement,
                   shard_edges=shard_edges, shard_topk=shard_topk,
                   shard_halo=shard_halo)
    for name, val in updates.items():
        if val is None:
            continue
        row = getattr(trace, name)[r]
        if isinstance(val, torch.Tensor):
            row.copy_(val)
        elif row.dim():
            row.copy_(torch.as_tensor(val, dtype=row.dtype))
        else:
            row.fill_(val)
    trace.rounds.clamp_(min=int(r) + 1)
    return trace


def _rows(trace: SolveTrace) -> list[dict]:
    """Host-side per-round dict rows (this is where the sync happens)."""
    n = int(trace.rounds)
    host = {k: v.detach().cpu() for k, v in trace._asdict().items()}
    rows = []
    shards = int(trace.shard_edges.shape[-1])
    for r in range(n):
        row = {
            "round": r,
            "lower_bound": float(host["lower_bound"][r]),
            "objective": float(host["objective"][r]),
            "n_cycles": int(host["n_cycles"][r]),
            "n_contracted": int(host["n_contracted"][r]),
            "n_clusters": int(host["n_clusters"][r]),
            "mp_improvement": float(host["mp_improvement"][r]),
        }
        if shards > 1:
            for k in ("shard_edges", "shard_topk", "shard_halo"):
                row[k] = [int(x) for x in host[k][r]]
        rows.append(row)
    return rows


def _imbalance(per_shard: list[int]) -> float:
    """max/mean load ratio: 1.0 = perfectly balanced; 0 total -> 1.0."""
    if not per_shard:
        return 1.0
    mean = sum(per_shard) / len(per_shard)
    return max(per_shard) / mean if mean > 0 else 1.0


def summarize(trace: SolveTrace) -> dict:
    """Host-side digest of a trace: per-round rows, convergence trajectory
    (first/best/final LB and objective, the gap), and, for traces with
    more than one shard, per-round imbalance ratios of edges / top-k
    anchors / halo pressure. The only trace consumer that pulls values to
    the host; call it off the hot path."""
    rows = _rows(trace)
    out = {"rounds": len(rows), "per_round": rows}
    if not rows:
        return out

    finite_obj = [r["objective"] for r in rows
                  if r["objective"] != float("inf")]
    lbs = [r["lower_bound"] for r in rows
           if r["lower_bound"] != float("-inf")]
    if lbs:
        out["lower_bound"] = {"first": lbs[0], "best": max(lbs),
                              "final": lbs[-1]}
    if finite_obj:
        out["objective"] = {"first": finite_obj[0], "best": min(finite_obj),
                            "final": finite_obj[-1]}
    if lbs and finite_obj:
        out["gap"] = finite_obj[-1] - max(lbs)
    out["total_contracted"] = sum(r["n_contracted"] for r in rows)
    out["total_cycles"] = sum(r["n_cycles"] for r in rows)

    shards = int(trace.shard_edges.shape[-1])
    if shards > 1:
        out["state_shards"] = shards
        out["shard_balance"] = {
            key: {
                "per_round_imbalance": [
                    round(_imbalance(r[field]), 4) for r in rows],
                "max_imbalance": round(
                    max(_imbalance(r[field]) for r in rows), 4),
            }
            for key, field in (("edges", "shard_edges"),
                               ("topk", "shard_topk"),
                               ("halo", "shard_halo"))
        }
    return out
