"""Request-lifecycle tracing for the serving tier: span records with
request ids, exportable as Chrome-trace / Perfetto JSON (a copy of
``repro.obs.spans``; the port imports nothing of the JAX package).

The engine moves a request through admit → enqueue → flush decision →
dispatch → harvest → demux. A :class:`SpanRecorder` stamps complete spans
(name, t0, t1, ids, args) as requests move, and :meth:`to_chrome_trace`
renders them in the Trace Event Format that ``chrome://tracing`` and
https://ui.perfetto.dev load — one row ("thread") per request.

* **Cheap when off** — the engine holds ``tracer=None`` by default and
  every call site is ``if tracer is not None`` guarded.
* **Cheap when on** — recording appends a small object; the engine passes
  its own clock timestamps in, so spans share the timebase of its walls.
* **Bounded** — ``max_events`` caps memory; on overflow the recorder
  drops new events and counts them (``n_dropped``).

Timestamps are seconds on the engine's clock; export converts to the
microseconds Chrome expects, offset from the first event.
"""
from __future__ import annotations

import json
from typing import Optional

__all__ = ["Span", "SpanRecorder"]

# Trace Event Format phase codes (the subset we emit):
#   "X" complete event (ts + dur), "i" instant event.
_COMPLETE = "X"
_INSTANT = "i"


class Span:
    """One recorded event. ``dur_s`` None means an instant marker."""

    __slots__ = ("name", "cat", "t0_s", "dur_s", "tid", "args")

    def __init__(self, name: str, cat: str, t0_s: float,
                 dur_s: Optional[float], tid: int, args: dict):
        self.name = name
        self.cat = cat
        self.t0_s = t0_s
        self.dur_s = dur_s
        self.tid = tid
        self.args = args

    def __repr__(self):
        dur = "instant" if self.dur_s is None else f"{self.dur_s:.6f}s"
        return f"Span({self.name!r}, t0={self.t0_s:.6f}, {dur}, tid={self.tid})"


class SpanRecorder:
    """Collects spans from one engine; export with :meth:`to_chrome_trace`
    (dict) or :meth:`to_json` (string) and open in Perfetto.

    ``tid`` convention (one Chrome "thread" = one swimlane): per-request
    spans use the request id so each request gets its own lane; engine-
    level events (flush decisions, dispatches, harvests) use ``tid=0``,
    the "engine" lane. Request ids are assigned by the engine
    (monotonic ints) and threaded through every span of that request's
    life, so a lane reads admit → queued → solve → demux left to right.
    """

    ENGINE_TID = 0

    def __init__(self, max_events: int = 100_000,
                 process_name: str = "repro.serve"):
        if max_events <= 0:
            raise ValueError("max_events must be positive")
        self.max_events = max_events
        self.process_name = process_name
        self._spans: list[Span] = []
        self.n_dropped = 0

    def __len__(self) -> int:
        return len(self._spans)

    @property
    def spans(self) -> list[Span]:
        return self._spans

    def record_span(self, name: str, t0_s: float, t1_s: float, *,
                    tid: int = ENGINE_TID, cat: str = "serve",
                    **args) -> None:
        """A complete span [t0_s, t1_s] (engine-clock seconds)."""
        if len(self._spans) >= self.max_events:
            self.n_dropped += 1
            return
        self._spans.append(Span(name, cat, t0_s, max(t1_s - t0_s, 0.0),
                                tid, args))

    def record_instant(self, name: str, t_s: float, *,
                       tid: int = ENGINE_TID, cat: str = "serve",
                       **args) -> None:
        """A zero-duration marker (flush decision, admit, eviction)."""
        if len(self._spans) >= self.max_events:
            self.n_dropped += 1
            return
        self._spans.append(Span(name, cat, t_s, None, tid, args))

    def append(self, span: Span) -> bool:
        """Adopt a span built by the caller, who may finish it later (the
        solve path's phases append a span when it opens, so an enclosed
        span can name it by index). False when dropped."""
        if len(self._spans) >= self.max_events:
            self.n_dropped += 1
            return False
        self._spans.append(span)
        return True

    def clear(self) -> None:
        self._spans.clear()
        self.n_dropped = 0

    def to_chrome_trace(self) -> dict:
        """Trace Event Format JSON-object: ``{"traceEvents": [...]}``.
        Loadable by chrome://tracing and ui.perfetto.dev as-is."""
        t_base = min((s.t0_s for s in self._spans), default=0.0)
        events = [
            # process/thread name metadata so Perfetto labels the lanes
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": self.process_name}},
            {"ph": "M", "pid": 1, "tid": self.ENGINE_TID,
             "name": "thread_name", "args": {"name": "engine"}},
        ]
        named_tids = {self.ENGINE_TID}
        for s in self._spans:
            if s.tid not in named_tids:
                named_tids.add(s.tid)
                events.append({"ph": "M", "pid": 1, "tid": s.tid,
                               "name": "thread_name",
                               "args": {"name": f"req {s.tid}"}})
            ev = {
                "name": s.name,
                "cat": s.cat,
                "ph": _COMPLETE if s.dur_s is not None else _INSTANT,
                "ts": (s.t0_s - t_base) * 1e6,      # µs
                "pid": 1,
                "tid": s.tid,
            }
            if s.dur_s is not None:
                ev["dur"] = s.dur_s * 1e6
            else:
                ev["s"] = "t"                        # instant scope: thread
            if s.args:
                ev["args"] = {k: v for k, v in s.args.items()}
            events.append(ev)
        meta = {"n_spans": len(self._spans), "n_dropped": self.n_dropped}
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": meta}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_chrome_trace(), **kw)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())
            fh.write("\n")
