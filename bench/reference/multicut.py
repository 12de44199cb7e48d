"""The plain reference of a multicut answer, in NumPy.

It imports nothing of the program and takes nothing that the program
made: the instance is the one the benchmark generated, and the program's
answer (labels, objective, lower bound, cluster count, separation's
round-0 cycles) is only read to be judged. Every number it returns is
0 for a sound answer or grows with the fault:

``partition_faults``
    nodes whose label lies outside ``[0, n_clusters)`` plus cluster ids
    in that range that no node carries.
``objective_rel_err``
    |reported objective - the cut's cost recounted in float64| /
    max(1, |recount|).
``bound_excess``
    how far the lower bound lies above the least objective the reference
    knows (the answer's own partition, the planted segmentation, one
    cluster), relative to it; infinite for a bound that is not finite.
``cluster_share``
    clusters over nodes: 1 where the solve left every node alone.
``lift_inv``
    1 / (1e-6 + lift), where lift = (lower bound - trivial bound) /
    |trivial bound| is how far message passing raised the bound above
    Σ_e min(0, c_e), the bound with no cycle at all; a message passing
    that leaves its costs unchanged reads about 1e6 (0 where the trivial
    bound is 0, and so exact).
``cycle_faults``
    round-0 triangles that are not a closed triangle of the instance and
    the zero-cost chords that separation added to its free slots.
``tri_inv``
    1 / (1 + the round-0 triangles separation returned valid): 1 where it
    found none.

:func:`judge` also returns ``recount`` (the cut's cost) and ``trivial``
(the trivial bound), which depend on the answer's labels and on the
instance alone; ``pd_gap_pct`` reads them.

:func:`control_bf16` is the control: this reference put in the
program's place in bfloat16, the precision below the float32 that the
configurations state.
"""
from __future__ import annotations

import numpy as np


def cut_cost(u, v, cost, labels) -> float:
    """The cost of the edges that ``labels`` cut, summed in float64."""
    lab = np.asarray(labels)
    return float(np.asarray(cost, dtype=np.float64)[lab[u] != lab[v]].sum())


def trivial_bound(cost) -> float:
    """Σ_e min(0, c_e): the bound with no cycle at all, in float64."""
    return float(np.minimum(np.asarray(cost, dtype=np.float64), 0.0).sum())


def partition_faults(labels, n_clusters: int) -> int:
    lab = np.asarray(labels, dtype=np.int64)
    outside = int(((lab < 0) | (lab >= n_clusters)).sum())
    used = np.unique(lab[(lab >= 0) & (lab < n_clusters)]).size
    return outside + int(n_clusters - used)


def judge(inst, answer: dict) -> dict:
    """The numbers of one primal-dual answer. ``inst`` has ``u``, ``v``,
    ``cost``, ``num_nodes`` and ``planted``; ``answer`` has ``labels``,
    ``objective``, ``lower_bound`` and ``n_clusters`` (after the last
    round)."""
    u, v, cost = inst.u, inst.v, inst.cost
    known = [0.0, cut_cost(u, v, cost, inst.planted)]
    lb = float(answer["lower_bound"])
    triv = trivial_bound(cost)
    out = {"trivial": triv, "lift_inv": lift_inv(lb, triv)}
    labels = np.asarray(answer["labels"])
    k = int(answer["n_clusters"])
    out["partition_faults"] = partition_faults(labels, k) + abs(
        len(labels) - inst.num_nodes)
    mine = cut_cost(u, v, cost, labels[:inst.num_nodes])
    known.append(mine)
    out["recount"] = mine
    obj = float(answer["objective"])
    out["objective_rel_err"] = abs(obj - mine) / max(1.0, abs(mine)) \
        if np.isfinite(obj) else float("inf")
    out["cluster_share"] = k / inst.num_nodes
    best = min(known)
    out["bound_excess"] = max(0.0, lb - best) / max(1.0, abs(best)) \
        if np.isfinite(lb) else float("inf")
    return out


def lift_inv(lb: float, trivial: float) -> float:
    """1 / (1e-6 + the bound's lift over ``trivial``, relative to it)."""
    if trivial == 0:
        return 0.0
    if not np.isfinite(lb):
        return float("inf")
    return 1.0 / (1e-6 + max(0.0, lb - trivial) / abs(trivial))


def tri_inv(cycles: dict) -> float:
    """1 / (1 + the valid round-0 triangles)."""
    return 1.0 / (1 + int(np.asarray(cycles["valid"], dtype=bool).sum()))


def cycle_faults(inst, cycles: dict) -> int:
    """Round-0 triangles that are not closed triangles of ``inst`` plus its
    chords. ``cycles``: ``tri`` (T, 3) edge ids, ``valid`` (T,), and the
    slots from ``first_chord`` on as separation left them (``chord_u``,
    ``chord_v``, ``chord_cost``, ``chord_valid``); slots below
    ``first_chord`` are the instance's own edges."""
    E = int(cycles["first_chord"])
    if E != len(inst.u):
        return int(np.asarray(cycles["valid"]).sum()) or 1
    tri = np.asarray(cycles["tri"], dtype=np.int64)[
        np.asarray(cycles["valid"], dtype=bool)]
    cu = np.asarray(cycles["chord_u"], dtype=np.int64)
    cv = np.asarray(cycles["chord_v"], dtype=np.int64)
    cc = np.asarray(cycles["chord_cost"])
    cok = np.asarray(cycles["chord_valid"], dtype=bool)
    ids = tri.reshape(-1)
    bad = (ids < 0) | (ids >= E + len(cu))
    ids = np.where(bad, 0, ids)
    chord = ids >= E
    j = np.where(chord, ids - E, 0)
    bad |= chord & (~cok[j] | (cc[j] != 0))
    a = np.where(chord, cu[j], np.asarray(inst.u, dtype=np.int64)[
        np.where(chord, 0, ids)])
    b = np.where(chord, cv[j], np.asarray(inst.v, dtype=np.int64)[
        np.where(chord, 0, ids)])
    ends = np.sort(np.stack([a, b], 1).reshape(-1, 6), axis=1)
    closed = (ends[:, 0] == ends[:, 1]) & (ends[:, 2] == ends[:, 3]) \
        & (ends[:, 4] == ends[:, 5]) & (ends[:, 1] < ends[:, 2]) \
        & (ends[:, 3] < ends[:, 4])
    return int((bad.reshape(-1, 3).any(1) | ~closed).sum())


def to_bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), kept
    in float32."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def control_bf16(inst) -> dict:
    """The reference in the program's place, in bfloat16: the planted
    segmentation as its partition, its objective summed from bfloat16
    costs (float32 accumulation) and returned in bfloat16, and the
    trivial bound the same way."""
    c = to_bf16(inst.cost)
    lab = np.asarray(inst.planted)
    cut = lab[inst.u] != lab[inst.v]
    obj = to_bf16(np.float32(c[cut].sum(dtype=np.float32)))
    lb = to_bf16(np.float32(np.minimum(c, 0).sum(dtype=np.float32)))
    _, labels = np.unique(lab, return_inverse=True)
    return dict(labels=labels, objective=float(obj), lower_bound=float(lb),
                n_clusters=int(labels.max()) + 1)
