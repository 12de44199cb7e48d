"""Spans and counters inside the solve: where a solve's time and host syncs
go, recorded by the solve path itself.

:func:`phase` opens one phase of a solve (``solve``, ``round``,
``separation``, ``contraction.cc``, ...). It is the one helper at every
boundary of the solve path, and it also opens the three ``repro.*``
``record_function`` ranges of a round (``range=``), so both traces name a
phase one way.

* **Off** (the default): one check, then the bare ``record_function`` of
  ``range`` or a shared no-op. Nothing is recorded, no CUDA event is
  created and no device reduction is launched: call sites guard their
  span arguments with ``if sp:``, and an off phase is falsy.
* **On** while ``torch.profiler`` records, or inside
  :func:`solver_tracing`. Each phase then appends a
  :class:`~repro_torch.obs.spans.Span` to :func:`solver_spans`' recorder
  when it opens: its name, ``tid`` = the id of the solve it belongs to
  (one lane a solve), ``args["parent"]`` = the index of the enclosing
  span in the recorder, ``args["r"]`` = the round, and host start and
  duration on the profiler's clock (``time.time_ns``, as seconds). On a
  CUDA solve the spans of :data:`TIMED` are bracketed by a pair of
  ``torch.cuda.Event(enable_timing=True)`` on the current stream; the
  events, and every tensor argument (a device scalar such as a round's
  live edges), are read only when :func:`solver_spans` is called, after a
  synchronise: ``args["device_ms"]`` is then the stream's time from one
  event to the other, idle gaps included.

The recorder holds one stretch of tracing: the first phase after tracing
was off empties it, so each profiler session or outermost
:func:`solver_tracing` block starts from nothing. Once it holds
``max_events`` spans, later phases record nothing and are counted in its
``n_dropped``.

No span opens a ``record_function`` range of its own: the benchmark gives
a phase the device time launched inside its innermost ``repro.*`` range,
so a nested range would take time from ``repro.contraction``.

:func:`solver_metrics` holds the solve path's host-sync counter, always on
(a host-side increment a sync, a few hundred a solve):
``solver_syncs_total.<site>``, one site for each place the solve path
waits for a card. A read of a CPU tensor waits for nothing and is not
counted. A ``solve`` span carries the counter's change over the solve in
``args["counters"]``.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.profiler import record_function

from repro_torch.obs.metrics import Counter, MetricsRegistry
from repro_torch.obs.spans import Span, SpanRecorder

__all__ = ["phase", "solver_tracing", "tracing", "solver_spans",
           "solver_metrics", "count_sync"]

CAT = "solver"
TIMED = ("solve", "contraction.forest", "contraction.cc")  # device_ms read
SYNCS = "solver_syncs_total"
SYNC_DEVICES = ("cuda",)    # device types whose reads wait for the device
ENGINE_TID = SpanRecorder.ENGINE_TID

_profiler_on = torch._C._autograd._profiler_enabled
_recorder = SpanRecorder(process_name="repro_torch.solver")
_metrics = MetricsRegistry()
_explicit = [0]             # depth of open solver_tracing() blocks
_was_off = [True]           # tracing was off at the last phase
_next_solve = [0]
_unread: list = []          # (span, start event, end event) not yet read
_local = threading.local()  # the thread's open phases


def tracing() -> bool:
    """Whether phases record now: a profiler recording or an open
    :func:`solver_tracing` block."""
    return _explicit[0] > 0 or _profiler_on()


@contextlib.contextmanager
def solver_tracing():
    """Record the solve path's spans inside the block, profiler or not."""
    if not tracing():
        _was_off[0] = True
    _explicit[0] += 1
    try:
        yield _recorder
    finally:
        _explicit[0] -= 1


def solver_metrics() -> MetricsRegistry:
    """The process registry of the solve path's counters."""
    return _metrics


def count_sync(site: str, device: torch.device, n: int = 1) -> None:
    """``n`` host syncs of the solve path at ``site``, where ``device``,
    the device waited for, is of a type in :data:`SYNC_DEVICES`."""
    if device.type in SYNC_DEVICES:
        _metrics.counter(f"{SYNCS}.{site}").inc(n)


def solver_spans() -> SpanRecorder:
    """The recorder of the solve path's spans, every span read: CUDA events
    turned into ``args["device_ms"]`` and tensor arguments into numbers
    (this synchronises; call it after the solves, never during one)."""
    pending = _unread[:]
    _unread.clear()
    for sp, start, end in pending:
        if start is not None:
            end.synchronize()
            sp.args["device_ms"] = start.elapsed_time(end)
        for k, v in sp.args.items():
            if isinstance(v, torch.Tensor):
                sp.args[k] = v.item()
    return _recorder


def _counters() -> dict:
    return {m.name: m.value for m in _metrics if isinstance(m, Counter)}


class _Off(record_function):
    """A phase while tracing is off that still opens its ``repro.*``
    range."""

    def __bool__(self):
        return False

    def set(self, **args) -> None:
        pass


class _Noop:
    """The shared phase while tracing is off (no range)."""

    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NOOP = _Noop()


class _Phase:
    """One recorded phase (tracing on)."""

    __slots__ = ("name", "args", "range", "span", "index", "dev", "ev",
                 "before")

    def __init__(self, name: str, range_name, args: dict):
        self.name, self.range, self.args = name, range_name, args

    def __bool__(self):
        return True

    def set(self, **args) -> None:
        """Add arguments (kept as given; tensors are read later)."""
        self.span.args.update(args)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        args = self.args
        if self.name == "solve":
            _next_solve[0] += 1
            tid = _next_solve[0]
            dev = args.pop("device", None)
            dev = None if dev is None else torch.device(dev)
            self.dev = dev if dev is not None and dev.type == "cuda" else None
            self.before = _counters()
        else:
            tid = up.span.tid if up is not None else ENGINE_TID
            self.dev = up.dev if up is not None else None
            if up is not None and "r" in up.span.args:
                args.setdefault("r", up.span.args["r"])
        stack.append(self)
        self.index = len(_recorder)
        span = self.span = Span(
            self.name, CAT, 0.0, None, tid,
            dict(args, parent=up.index if up is not None else None))
        _recorder.append(span)
        # the host clock is read next to the range's own stamps
        rf = None if self.range is None else record_function(self.range)
        span.t0_s = time.time_ns() / 1e9
        if rf is not None:
            self.range = rf.__enter__()
        self.ev = None
        if self.dev is not None and self.name in TIMED:
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record(torch.cuda.current_stream(self.dev))
        return self

    def __exit__(self, *exc):
        end = None
        if self.ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.dev))
        if self.range is not None:
            self.range.__exit__(*exc)
        t1 = time.time_ns() / 1e9
        _local.stack.pop()
        span = self.span
        span.dur_s = max(t1 - span.t0_s, 0.0)
        if self.name == "solve":
            now = _counters()
            span.args["counters"] = {
                k: v - self.before.get(k, 0) for k, v in now.items()
                if v != self.before.get(k, 0)}
        _unread.append((span, self.ev, end))
        return False


def phase(name: str, range: str | None = None, **args):
    """The context manager of one solve-path phase ``name``; ``range``
    names the ``record_function`` range it also opens, on or off. A
    ``solve`` phase takes ``device=`` (its instance's), which decides
    whether its phases are timed by CUDA events. The value it yields is
    falsy while tracing is off or the recorder is full; its
    ``set(**args)`` adds arguments."""
    if not tracing():
        _was_off[0] = True
        return _Off(range) if range is not None else _NOOP
    if _was_off[0]:
        _was_off[0] = False
        _recorder.clear()
        _unread.clear()
    if len(_recorder) >= _recorder.max_events:
        _recorder.n_dropped += 1
        return _Off(range) if range is not None else _NOOP
    return _Phase(name, range, args)
