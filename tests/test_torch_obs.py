"""The port's copies of the metrics registry and the span recorder
(``repro_torch.obs``) against the JAX package's modules: the same sequence
of calls gives the same JSON snapshot, Prometheus text and Chrome trace,
exactly (host-side Python, no floats computed in another order); and
``register_compile_metrics`` reads the port's registry.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

from repro.obs import metrics as jmet  # noqa: E402
from repro.obs import spans as jspans  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.obs import metrics as tmet  # noqa: E402
from repro_torch.obs import spans as tspans  # noqa: E402


def _drive_metrics(mod, seed: int, growth: float):
    """One fixed sequence of registry calls on module ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("requests_total", "requests seen")
    for n in rng.integers(0, 5, size=7):
        c.inc(float(n))
    g = reg.gauge("queue_depth", "queued")
    g.set(float(rng.integers(0, 9)))
    box = [3]
    reg.gauge("live", "callback", fn=lambda: box[0])
    box[0] = 11
    h = reg.histogram("latency_seconds", "latency", growth=growth)
    for v in rng.lognormal(-3.0, 2.0, size=200):
        h.observe(v)
    h.observe(0.0)                  # underflow
    h.observe(5e3)                  # overflow
    ext = mod.Histogram("ext_seconds", "adopted", lo=1e-3, hi=10.0)
    for v in rng.uniform(0.0, 20.0, size=50):
        ext.observe(v)
    reg.register(ext)
    return reg


@pytest.mark.parametrize("growth", [2.0 ** (1 / 8), 1.5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_snapshot_and_prometheus_match(seed, growth):
    j = _drive_metrics(jmet, seed, growth)
    t = _drive_metrics(tmet, seed, growth)
    assert t.snapshot() == j.snapshot()
    assert t.to_json(sort_keys=True) == j.to_json(sort_keys=True)
    assert t.to_prometheus() == j.to_prometheus()
    h_t, h_j = t.get("latency_seconds"), j.get("latency_seconds")
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert h_t.quantile(q) == h_j.quantile(q)
    assert tmet.quantile_error_bound(growth) == \
        jmet.quantile_error_bound(growth)


@pytest.mark.parametrize("mod", [jmet, tmet], ids=["jax", "port"])
def test_metrics_errors_match(mod):
    reg = mod.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="must be >= 0"):
        reg.counter("x").inc(-1)
    with pytest.raises(ValueError, match="callback-backed"):
        reg.gauge("cb", fn=lambda: 1).set(2)
    with pytest.raises(ValueError, match="need 0 < lo < hi"):
        mod.Histogram("h", lo=1.0, hi=1.0)
    assert np.isnan(mod.Histogram("empty").quantile(0.5))


def _drive_spans(mod, max_events: int):
    rec = mod.SpanRecorder(max_events=max_events)
    t = 100.0
    for req in range(1, 5):
        rec.record_instant("admit", t, tid=req, nodes=64, mode="pd",
                           deadline_s=None)
        rec.record_span("queued", t, t + 0.01 * req, tid=req)
        rec.record_span("solve", t + 0.01 * req, t + 0.05 * req, tid=req,
                        kind="solve")
        t += 0.003
    rec.record_instant("flush", t, reason="timeout", queued=3)
    rec.record_span("harvest", t, t + 0.02, kind="solve", n_slots=4)
    rec.record_span("backwards", t + 1.0, t + 0.5)     # clamped to 0
    return rec


@pytest.mark.parametrize("max_events", [1000, 7])
def test_spans_chrome_trace_matches(max_events):
    j = _drive_spans(jspans, max_events)
    t = _drive_spans(tspans, max_events)
    assert len(t) == len(j) and t.n_dropped == j.n_dropped
    assert t.to_chrome_trace() == j.to_chrome_trace()
    assert t.to_json(sort_keys=True) == j.to_json(sort_keys=True)
    json.loads(t.to_json())
    t.clear()
    assert len(t) == 0 and t.n_dropped == 0


def test_compile_metrics_read_the_port_registry():
    tapi.clear_cache()
    reg = tobs.register_compile_metrics(tobs.MetricsRegistry())
    snap = reg.snapshot()
    assert snap["compile_traces_total"]["value"] == 0
    assert snap["compile_cache_size"]["value"] == 0
    tapi.compiled_solve(mode="pd")
    tapi.compiled_solve(mode="pd")
    snap = reg.snapshot()
    assert snap["compile_cache_misses"]["value"] == 1
    assert snap["compile_cache_hits"]["value"] == 1
    assert snap["compile_cache_size"]["value"] == 1
    assert "compile_traces_total 0" in reg.to_prometheus()
