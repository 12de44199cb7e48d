"""The solve path's own spans (``repro_torch.obs.solver_spans``), for the
readers of the metrics that the program records itself.

A ``--trace 1`` window runs under ``torch.profiler``, which turns the
program's phase spans on; nothing solves after the window closes, so the
window's solves are the last ``len(run.records)`` ``solve`` spans, and
every span from the first of them on belongs to the window. A span names
its enclosing span by its index in the recorder (``args["parent"]``).
:func:`window` gives None where the run was not traced, the program
records no such spans (an older program), the recorder dropped any, or
it holds fewer solves than the window ran: a reader then reports
nothing.
"""
from __future__ import annotations


class Window:
    """The window's spans: ``spans`` is the recorder's whole list (parents
    are indices into it), ``first`` the index of the window's first
    ``solve`` span, ``solves`` how many solves the window ran."""

    def __init__(self, spans: list, first: int, solves: int):
        self.spans, self.first, self.solves = spans, first, solves

    def named(self, name: str) -> list:
        return [s for s in self.spans[self.first:] if s.name == name]

    def parent(self, span):
        return self.spans[span.args["parent"]]


def window(run) -> Window | None:
    if run.trace is None or not run.records:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    read = getattr(obs, "solver_spans", None)
    if read is None:
        return None
    rec = read()
    if rec.n_dropped:
        return None
    starts = [i for i, s in enumerate(rec.spans) if s.name == "solve"]
    n = len(run.records)
    if len(starts) < n:
        return None
    return Window(rec.spans, starts[-n], n)


def device_ms_per_solve(w: Window, spans: list):
    """The CUDA-event spans of ``spans`` (idle gaps inside them included),
    summed, per solve; None where a span has none (a run off the card)."""
    if not spans or any("device_ms" not in s.args for s in spans):
        return None
    return sum(s.args["device_ms"] for s in spans) / w.solves
