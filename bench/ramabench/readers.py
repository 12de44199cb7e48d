"""Arithmetic that the metric readers in ``bench/metrics/`` share. A
reader returns None where its run holds nothing for it to read; a share
of a roofline is then left out, never reported as 0."""
from __future__ import annotations

from ramabench import work


def solves(run) -> int:
    return len(run.done_in_window)


def phase_ms_per_solve(run, phase: str, key: str):
    """A ``repro.*`` range's busy or host milliseconds over the traced
    window, per solve completed in it."""
    if run.trace is None or not solves(run):
        return None
    ph = run.trace["phases"].get(phase)
    if ph is None or not ph["count"]:
        return None
    return ph[key] * 1e3 / solves(run)


def kernel_seconds(run, symbols) -> float:
    """Device seconds of the events whose name holds one of ``symbols``."""
    return sum(k["s"] for name, k in run.trace["kernels"].items()
               if any(s in name for s in symbols))


def roofline_pct(min_s: float, device_s: float):
    if device_s <= 0 or min_s <= 0:
        return None
    return 100.0 * min_s / device_s


def triangle_mp_min_seconds(run) -> float:
    return sum(work.min_seconds(*work.triangle_mp_phase(t, tv, it),
                                "fp32_ops_per_s")
               for t, tv, it in run.capture.mp_calls)


def cycle_intersect_min_seconds(run) -> float:
    return sum(work.min_seconds(*work.cycle_intersect(*shape),
                                "int32_ops_per_s")
               for shape in run.capture.intersect_calls)


def contraction_min_seconds(run) -> float:
    return sum(work.contraction(*c) for c in run.capture.contractions) \
        / work.PEAKS["hbm_bytes_per_s"]


def idle_pct(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
