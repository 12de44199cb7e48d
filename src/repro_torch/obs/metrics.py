"""Metrics registry: counters, gauges, and log-bucketed histograms with
bounded memory and a proven quantile error bound (a copy of
``repro.obs.metrics``; the port imports nothing of the JAX package).

:class:`Histogram` keeps geometrically spaced buckets over a fixed
``[lo, hi)`` range, so memory is O(log(hi/lo) / log(growth)) — a couple
hundred ints regardless of traffic — and a quantile estimate (the upper
edge of the bucket where the cumulative count crosses the rank) is wrong
by at most a factor of ``growth`` relative: the true value lies in
``(edge / growth, edge]``. With the default ``growth = 2**(1/8)`` that is
a ≤ 9.06% relative overestimate, independent of stream length.

Every metric type exposes itself in two machine formats:

* :meth:`MetricsRegistry.snapshot` — one JSON-ready dict;
* :meth:`MetricsRegistry.to_prometheus` — the Prometheus text exposition
  format (``# TYPE``/``# HELP`` + samples, histograms as cumulative
  ``_bucket{le=...}`` series).

Gauges may be backed by a zero-argument callable (``fn=``) evaluated at
collection time — that is how :func:`repro_torch.obs
.register_compile_metrics` exports ``api.trace_count`` /
``api.cache_info`` without a second bookkeeping path.

Everything here is plain host-side Python: nothing runs on the device,
and recording a sample is a handful of arithmetic ops.
"""
from __future__ import annotations

import json
import math

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_GROWTH", "quantile_error_bound"]

DEFAULT_GROWTH = 2.0 ** (1.0 / 8.0)     # ≤ 9.06% relative quantile error
DEFAULT_LO = 1e-4                       # 100 µs — below jit dispatch noise
DEFAULT_HI = 1e3                        # ~17 min — beyond any sane request


def quantile_error_bound(growth: float) -> float:
    """The exact relative-error guarantee of :meth:`Histogram.quantile`:
    the estimate overestimates the true order statistic by strictly less
    than ``growth - 1`` (the true value is in ``(edge/growth, edge]``)."""
    return growth - 1.0


def _sanitize(name: str) -> str:
    """Prometheus metric names: ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


class Counter:
    """Monotone cumulative counter."""

    kind = "counter"
    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) must be >= 0")
        self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}

    def exposition(self) -> list[str]:
        n = _sanitize(self.name)
        return [f"# HELP {n} {self.help}", f"# TYPE {n} counter",
                f"{n} {_fmt(self._value)}"]


class Gauge:
    """Point-in-time value; ``fn`` makes it a collection-time callback
    (the value is whatever ``fn()`` returns when someone scrapes)."""

    kind = "gauge"
    __slots__ = ("name", "help", "_value", "_fn")

    def __init__(self, name: str, help: str = "", fn=None):
        self.name = name
        self.help = help
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        if self._fn is not None:
            raise ValueError(f"gauge {self.name} is callback-backed")
        self._value = float(v)

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}

    def exposition(self) -> list[str]:
        n = _sanitize(self.name)
        return [f"# HELP {n} {self.help}", f"# TYPE {n} gauge",
                f"{n} {_fmt(self.value)}"]


class Histogram:
    """Log-bucketed histogram over ``[lo, hi)`` with growth factor
    ``growth``: bucket ``i`` covers ``(lo * growth**(i-1), lo * growth**i]``
    (bucket 0 is the underflow ``(-inf, lo]``, the last bucket the
    overflow ``(hi, +inf)``). Memory is the fixed bucket array — about
    ``log(hi/lo)/log(growth)`` ints (186 at the defaults) — plus exact
    ``count``/``sum``/``min``/``max`` scalars.

    :meth:`quantile` returns the upper edge of the bucket where the
    cumulative count reaches the rank, clamped to the exact observed
    min/max; the relative error is < ``growth - 1``
    (:func:`quantile_error_bound`), with NO dependence on how many
    samples were observed — unlike a truncating window, old samples are
    never dropped.
    """

    kind = "histogram"
    __slots__ = ("name", "help", "lo", "hi", "growth", "_log_g", "_edges",
                 "_counts", "count", "sum", "_min", "_max")

    def __init__(self, name: str, help: str = "", lo: float = DEFAULT_LO,
                 hi: float = DEFAULT_HI, growth: float = DEFAULT_GROWTH):
        if not (0.0 < lo < hi):
            raise ValueError(f"histogram {name}: need 0 < lo < hi, got "
                             f"({lo}, {hi})")
        if growth <= 1.0:
            raise ValueError(f"histogram {name}: growth must be > 1, got "
                             f"{growth}")
        self.name = name
        self.help = help
        self.lo = lo
        self.hi = hi
        self.growth = growth
        self._log_g = math.log(growth)
        n = int(math.ceil(math.log(hi / lo) / self._log_g))
        # edges[i] = upper edge of bucket i; final bucket is the overflow
        self._edges = [lo * growth ** i for i in range(n + 1)]
        self._counts = [0] * (n + 3)    # underflow + n+1 finite + overflow
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    @property
    def n_buckets(self) -> int:
        return len(self._counts)

    def _bucket_of(self, v: float) -> int:
        if v <= self.lo:
            return 0
        if v > self.hi:
            return len(self._counts) - 1
        # smallest i with lo * growth**i >= v  (O(1), no scan)
        i = int(math.ceil(math.log(v / self.lo) / self._log_g - 1e-12))
        i = min(max(i, 0), len(self._edges) - 1)
        if self._edges[i] < v:          # float-log edge case: step right
            i += 1
        return 1 + i

    def observe(self, v: float) -> None:
        v = float(v)
        self._counts[self._bucket_of(v)] += 1
        self.count += 1
        self.sum += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)

    def quantile(self, q: float) -> float:
        """The ``q``-quantile (q in [0, 1]) with relative error <
        ``growth - 1``: the upper edge of the bucket holding the rank-th
        sample, clamped to the exact observed [min, max]. NaN when no
        samples have been observed."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self._counts):
            cum += c
            if cum >= rank and c > 0 or cum >= self.count:
                if i == 0:
                    edge = self.lo
                elif i == len(self._counts) - 1:
                    edge = self._max
                else:
                    edge = self._edges[i - 1]
                return min(max(edge, self._min), self._max)
        return self._max

    def percentile(self, p: float) -> float:
        return self.quantile(p / 100.0)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def snapshot(self) -> dict:
        out = {"type": "histogram", "count": self.count, "sum": self.sum,
               "error_bound": quantile_error_bound(self.growth)}
        if self.count:
            out.update(min=self._min, max=self._max, mean=self.mean,
                       p50=self.quantile(0.50), p90=self.quantile(0.90),
                       p99=self.quantile(0.99))
        return out

    def exposition(self) -> list[str]:
        n = _sanitize(self.name)
        lines = [f"# HELP {n} {self.help}", f"# TYPE {n} histogram"]
        cum = 0
        for i, c in enumerate(self._counts[:-1]):
            cum += c
            le = self.lo if i == 0 else self._edges[i - 1]
            lines.append(f'{n}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f"{n}_sum {_fmt(self.sum)}")
        lines.append(f"{n}_count {self.count}")
        return lines


def _fmt(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """A named collection of metrics with get-or-create accessors (so
    independent subsystems can share one registry without coordinating
    construction order), a JSON snapshot, and Prometheus exposition."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get_or_create(self, cls, name: str, *args, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m
        m = cls(name, *args, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "", fn=None) -> Gauge:
        return self._get_or_create(Gauge, name, help, fn)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get_or_create(Histogram, name, help, **kw)

    def register(self, metric) -> object:
        """Adopt an externally constructed metric (e.g. the engine's
        latency histogram, which lives on EngineStats)."""
        have = self._metrics.get(metric.name)
        if have is not None and have is not metric:
            raise ValueError(f"metric {metric.name!r} already registered")
        self._metrics[metric.name] = metric
        return metric

    def get(self, name: str):
        return self._metrics.get(name)

    def __len__(self) -> int:
        return len(self._metrics)

    def __iter__(self):
        return iter(self._metrics.values())

    def snapshot(self) -> dict:
        """JSON-ready ``{name: {type, ...}}`` view of every metric
        (callback gauges evaluated now)."""
        return {name: m.snapshot() for name, m in
                sorted(self._metrics.items())}

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), **kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4 (one scrape page)."""
        lines = []
        for _, m in sorted(self._metrics.items()):
            lines.extend(m.exposition())
        return "\n".join(lines) + "\n"
