"""repro_torch.obs: observability of the port (mirrors ``repro.obs``).

* :mod:`.trace` — :class:`SolveTrace`, the per-round solver telemetry
  ``api.solve(trace=True)`` returns, and :func:`summarize`, its host-side
  digest.
* :mod:`.spans` — :class:`SpanRecorder`, request-lifecycle spans with
  Chrome-trace / Perfetto JSON export.
* :mod:`.metrics` — :class:`MetricsRegistry` of counters, gauges and
  log-bucketed histograms, with JSON snapshot and Prometheus text.
* :mod:`.phases` — :func:`phase`, the spans of the solve path's phases
  (on under a profiler or :func:`solver_tracing`, read through
  :func:`solver_spans`), and :func:`solver_metrics`, its always-on
  counter of host syncs.

:func:`register_compile_metrics` folds the registry accounting of
:mod:`repro_torch.api` (``trace_count``, ``cache_info``) into a metrics
registry as callback gauges.
"""
from __future__ import annotations

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, quantile_error_bound)
from repro_torch.obs.phases import (count_sync, phase, solver_metrics,
                                    solver_spans, solver_tracing, tracing)
from repro_torch.obs.spans import Span, SpanRecorder
from repro_torch.obs.trace import (SolveTrace, init_trace, summarize,
                                   trace_set_round)

__all__ = [
    "SolveTrace", "init_trace", "trace_set_round", "summarize",
    "Span", "SpanRecorder",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "quantile_error_bound",
    "register_compile_metrics",
    "phase", "solver_tracing", "tracing", "solver_spans", "solver_metrics",
    "count_sync",
]


def register_compile_metrics(registry: MetricsRegistry) -> MetricsRegistry:
    """Export the api-level compile-budget accounting as callback gauges:

    * ``compile_traces_total`` — :func:`repro_torch.api.trace_count` (first
      calls of a registry callable at a new input shape);
    * ``compile_cache_hits`` / ``compile_cache_misses`` /
      ``compile_cache_size`` — :func:`repro_torch.api.cache_info` fields.

    Returns the registry for chaining."""
    from repro_torch import api  # deferred: obs alone loads no solver

    registry.gauge("compile_traces_total",
                   "jit traces taken (compile budget spent)",
                   fn=lambda: api.trace_count())
    registry.gauge("compile_cache_hits",
                   "compiled-executable registry hits",
                   fn=lambda: api.cache_info().hits)
    registry.gauge("compile_cache_misses",
                   "compiled-executable registry misses (each is a compile)",
                   fn=lambda: api.cache_info().misses)
    registry.gauge("compile_cache_size",
                   "live entries in the compiled-executable registry",
                   fn=lambda: api.cache_info().currsize)
    return registry
