"""The port's solve server (``repro_torch.serve``) on the CPU.

* Buckets, the batch ladder, its decomposition, the router and the
  session store against the JAX package's functions on the same inputs:
  exact (integer shapes and decisions; a Route's default backend is the
  port's kernels, ``"cuda"``, where the reference's is ``"reference"``).
* The engine's logic, counterparts of tests/test_serve_engine.py,
  test_serve_async.py and test_serve_session.py: fake-clock timeout and
  deadline flushes, submission order, admission limits, pinned routes, no
  filler-only batches, the compile budget, ``max_inflight=0`` bit-identical
  to the overlapped engine, sessions micro-batching, exact ticks equal to
  a cold solve, LRU eviction. Engine results are held bit for bit against
  the port's ``api.solve`` of the same bucket-padded instance.
* One small mixed stream (two bucket shapes) against JAX's ``api.solve``
  of the same bucket-padded instances: integers exact, objective and
  bound within rtol 1e-5 (float32 sums in another order, as in
  tests/test_torch_solve.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.convert import instance_from_numpy, result_to_numpy  # noqa: E402,E501
from repro_torch.core.graph import random_instance  # noqa: E402
from repro_torch.incremental import apply_patch_host  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BucketPolicy, Route, Router, RoutingRule, SolveEngine, batch_ladder,
    decompose_batch, pad_instance,
)

RTOL = 1e-5
CFG_KW = dict(max_neg=32, mp_iters=2, max_rounds=4)
CFG_DENSE = api.SolverConfig(graph_impl="dense", **CFG_KW)
CFG_SPARSE = api.SolverConfig(graph_impl="sparse", sparse_row_cap=64,
                              **CFG_KW)
CFG_DELTA = api.SolverConfig(max_neg=16, mp_iters=2, max_rounds=3,
                             graph_impl="dense")
ROUTE_D = Route(mode="pd", config=CFG_DENSE)
ROUTE_S = Route(mode="pd", config=CFG_SPARSE)
POLICY = BucketPolicy(node_floor=16, edge_floor=64)
INTS = ("labels", "rounds", "n_contracted", "n_clusters")


def _router():
    """Small → dense, larger → sparse: a mixed stream spans both."""
    return Router(rules=[RoutingRule(route=ROUTE_D, max_nodes=24)],
                  default=ROUTE_S)


def _engine(**kw):
    kw.setdefault("router", _router())
    kw.setdefault("policy", POLICY)
    kw.setdefault("flush_timeout_s", None)
    return SolveEngine(device="cpu", **kw)


def _mixed_stream(n, seed=7):
    rng = np.random.default_rng(seed)
    return [random_instance(int(rng.integers(8, 48)), 0.4, seed=s,
                            device="cpu") for s in range(n)]


def _small(seed):
    return random_instance(12, 0.5, seed=seed, pad_edges=64, pad_nodes=16,
                           device="cpu")


def _large(seed):
    return random_instance(28, 0.4, seed=seed, pad_edges=256, pad_nodes=32,
                           device="cpu")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _bitwise(a, b):
    for f, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f


def _direct(eng, inst):
    """The port's api.solve of the bucket-padded instance on its route,
    labels cut back to the request's own length."""
    bucket = eng.policy.bucket_of(inst)
    route = eng._resolve_route(bucket, eng.router.route_instance(inst), inst)
    r = api.solve(pad_instance(inst, bucket), mode=route.mode,
                  config=route.config, backend=route.backend, device="cpu")
    return r._replace(labels=r.labels[:inst.num_nodes])


# ---------------------------------------------------------------------------
# buckets, ladder, router, session store: against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy_kw", [
    {}, dict(node_floor=16, edge_floor=64),
    dict(node_floor=10, edge_floor=30, growth=1.5),
    dict(node_floor=16, edge_floor=64, node_cap=100, edge_cap=1000)])
def test_bucket_policy_matches_jax(policy_kw):
    tp, jp = BucketPolicy(**policy_kw), jserve.BucketPolicy(**policy_kw)
    for n in (0, 1, 15, 16, 17, 33, 64, 99, 100, 257, 16384, 131072):
        for e in (0, 1, 63, 64, 65, 700, 999, 2_610_185):
            try:
                want = tuple(jp.bucket_for(n, e))
            except ValueError as err:
                with pytest.raises(ValueError, match="policy cap"):
                    tp.bucket_for(n, e)
                assert "policy cap" in str(err)
                continue
            assert tuple(tp.bucket_for(n, e)) == want
    with pytest.raises(ValueError, match="growth"):
        BucketPolicy(growth=1.0)


def test_pad_filler_and_strip_match_jax():
    ji = jg.random_instance(20, 0.3, seed=4)
    ti = instance_from_numpy(*[np.asarray(x) for x in ji], device="cpu")
    b = jserve.BucketPolicy().bucket_of(ji)
    tb = BucketPolicy().bucket_of(ti)
    assert tuple(tb) == tuple(b)
    for t, j in ((pad_instance(ti, tb), jserve.pad_instance(ji, b)),
                 (serve.filler_instance(tb, "cpu"),
                  jserve.filler_instance(b))):
        for x, y in zip(t, j):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert pad_instance(ti, serve.Bucket(20, ti.num_edges)) is ti
    with pytest.raises(ValueError, match="exceeds bucket"):
        pad_instance(ti, serve.Bucket(8, 8))
    batch = serve.pad_batch([ti, ti], tb, 4)
    assert batch.u.shape == (4, tb.edges)
    assert not batch.edge_valid[2:].any() and not batch.node_valid[2:].any()
    res = api.solve(pad_instance(ti, tb), config=CFG_DENSE, device="cpu")
    assert serve.strip_result(res, 20).labels.shape == (20,)
    with pytest.raises(ValueError, match="exceed the batch"):
        serve.pad_batch([ti] * 3, tb, 2)


def test_ladder_and_decompose_match_jax():
    for cap in (1, 2, 3, 4, 6, 8, 16):
        for shards in (1, 2, 4):
            try:
                want = jserve.batch_ladder(cap, shards)
            except ValueError:
                with pytest.raises(ValueError):
                    batch_ladder(cap, shards)
                continue
            rungs = batch_ladder(cap, shards)
            assert rungs == want
            for n in range(1, 3 * cap + 2):
                assert decompose_batch(n, rungs) == \
                    jserve.decompose_batch(n, want)
    with pytest.raises(ValueError):
        decompose_batch(0, (4, 2, 1))


def _route_key(r):
    return (r.mode, r.config.cache_key(), r.batch_shards)


SPEC = {"rules": [
    {"max_nodes": 64, "preset": "paper-pd",
     "config": {"graph_impl": "dense"}},
    {"max_nodes": 4096, "max_edges": 20000, "preset": "pd-chunked",
     "traffic": "solve"},
    {"mode": "pd+", "config": {"max_rounds": 3}, "traffic": "delta"}],
    "default": {"mode": "pd", "config": {"graph_impl": "sparse"}}}


@pytest.mark.parametrize("which", ["default", "spec"])
def test_router_matches_jax(which):
    if which == "default":
        t, j = serve.default_router(), jserve.default_router()
    else:
        t, j = Router.from_spec(SPEC), jserve.Router.from_spec(SPEC)
    for n in (1, 64, 65, 256, 257, 4096, 5000, 131072):
        for e in (10, 19999, 20001):
            for traffic in ("solve", "delta"):
                assert _route_key(t.route(n, e, traffic)) == \
                    _route_key(j.route(n, e, traffic))
    for traffic in ("solve", "delta"):
        assert [_route_key(r) for r in t.candidates(traffic)] == \
            [_route_key(r) for r in j.candidates(traffic)]
    assert [_route_key(r) for r in t.routes()] == \
        [_route_key(r) for r in j.routes()]
    assert {r.backend for r in t.routes()} == {"cuda"}


@pytest.mark.parametrize("bad", [
    {"rules": [{"preset": "paper-pd", "colour": 1}]},
    {"rules": [{"mode": "pd", "config": {"no_such_field": 1}}]},
    {"rulez": []},
    {"rules": [{"mode": "pd", "traffic": "bulk"}]}])
def test_router_spec_errors_match_jax(bad):
    with pytest.raises(ValueError) as je:
        jserve.Router.from_spec(bad)
    with pytest.raises(ValueError) as te:
        Router.from_spec(bad)
    assert str(te.value) == str(je.value)


def test_session_store_lru_matches_jax():
    def run(mod):
        store = mod.SessionStore()
        log = []
        for _ in range(4):
            sid = store.allocate_id()
            store.add(mod.DeltaSession(sid, None, None, None, True, 1, 1))
        store.get("s1")
        store.touch("s0")
        log.append(store.lru().session_id)
        store.close(store.lru().session_id)
        log.append([s.session_id for s in store])
        log.append((len(store), "s2" in store, "s3" in store))
        with pytest.raises(KeyError):
            store.get("s2")
        with pytest.raises(ValueError, match="already open"):
            store.add(mod.DeltaSession("s3", None, None, None, True, 1, 1))
        return log
    assert run(serve) == run(jserve)


# ---------------------------------------------------------------------------
# the engine's logic on the CPU
# ---------------------------------------------------------------------------

def test_mixed_stream_end_to_end():
    api.clear_cache()
    eng = _engine(batch_cap=8)
    insts = _mixed_stream(24)
    results = eng.solve_stream(insts)
    assert len(results) == 24 and eng.pending == 0
    assert eng.stats.n_completed == 24
    keys = {(POLICY.bucket_of(i), eng.router.route_instance(i))
            for i in insts}
    assert len({k[1] for k in keys}) == 2       # both routes
    rungs = len(batch_ladder(eng.batch_cap))
    assert len(keys) <= eng.stats.compiles <= len(keys) * rungs
    assert eng.stats.n_filler_slots == 0 and eng.stats.occupancy == 1.0
    for inst, res in zip(insts, results):
        _bitwise(res, _direct(eng, inst))
        assert res.labels.shape == (inst.num_nodes,)


def test_timeout_flush_with_fake_clock():
    clock = FakeClock()
    eng = _engine(batch_cap=8, flush_timeout_s=0.5, clock=clock,
                  max_inflight=0)
    t = eng.submit(_small(0))
    assert not t.done and eng.pending == 1
    clock.advance(0.4)
    assert eng.pump() == 0 and not t.done
    clock.advance(0.2)
    assert eng.pump() == 1 and t.done
    assert eng.stats.n_filler_slots == 0
    assert t.latency_s == pytest.approx(0.6)


def test_deadline_pressure_flushes_early():
    clock = FakeClock()
    eng = _engine(batch_cap=8, flush_timeout_s=10.0, clock=clock,
                  max_inflight=0, tune_short_cap=False)
    inst = _small(0)
    bucket = eng.policy.bucket_of(inst)
    eng.stats.record_wall((bucket, ROUTE_D), 1.0, 8)
    t = eng.submit(inst, deadline_s=3.0)
    clock.advance(1.0)
    assert eng.pump() == 0      # 1.0 + 1.0 < 3.0
    clock.advance(1.2)
    assert eng.pump() == 1 and t.done
    assert eng.stats.n_deadline_missed == 0
    est = eng.stats.wall_ema((bucket, ROUTE_D))
    t2 = eng.submit(inst, deadline_s=est + 1.0)
    assert not t2.done
    clock.advance(est + 2.0)
    eng.pump()
    assert t2.done and eng.stats.n_deadlined == 2
    assert eng.stats.deadline_miss_rate == pytest.approx(0.5)


def test_tightest_deadline_queue_flushes_first():
    clock = FakeClock()
    eng = _engine(batch_cap=8, clock=clock, max_inflight=8,
                  ready_fn=lambda tree: False, tune_short_cap=False)
    ta = eng.submit(_small(1), deadline_s=5.0)
    tb = eng.submit(_large(1), deadline_s=1.0)
    clock.advance(10.0)
    assert eng.pump() == 2
    assert [e.key[0] for e in eng._inflight["cuda"]] == [tb.bucket,
                                                          ta.bucket]
    eng.drain()
    assert ta.done and tb.done and eng.stats.n_deadline_missed == 2


def test_submission_order_and_forced_queue():
    eng = _engine(batch_cap=4)
    insts = _mixed_stream(9, seed=3)
    for inst, res in zip(insts, eng.solve_stream(insts)):
        assert res.labels.shape == (inst.num_nodes,)
    t = eng.submit(_small(5))
    assert not t.done
    assert t.result().labels.shape == (16,) and t.done


def test_oversized_rejected_and_pinned_route():
    eng = _engine(policy=BucketPolicy(node_floor=16, edge_floor=64,
                                      node_cap=32), batch_cap=2)
    with pytest.raises(ValueError, match="policy cap"):
        eng.submit(random_instance(40, 0.3, seed=0, device="cpu"))
    assert eng.pending == 0
    inst = _small(0)
    pinned = Route(mode="p", config=CFG_DENSE)
    t = eng.submit(inst, route=pinned)
    assert t.route == pinned
    direct = api.solve(pad_instance(inst, t.bucket), mode="p",
                       config=CFG_DENSE, device="cpu")
    assert torch.equal(t.result().objective, direct.objective)


def test_no_filler_only_batches_and_warmup():
    api.clear_cache()
    eng = _engine(batch_cap=4, flush_timeout_s=0.0)
    assert eng.pump() == 0 and eng.flush() == 0 and eng.flush_deltas() == 0
    assert eng.stats.compiles == 0
    shapes = [(i.num_nodes, i.num_edges) for i in _mixed_stream(6)]
    fresh = eng.warmup(shapes)
    assert fresh == eng.stats.compiles > 0
    for t in eng.submit_many(_mixed_stream(6)):
        t.result()
    assert eng.stats.compiles == fresh          # warmed: no new first-call
    dispatches, fillers = eng.stats.n_dispatches, eng.stats.n_filler_slots
    assert eng.pump() == 0 and eng.pump(force=True) == 0
    assert eng.flush() == 0
    assert (eng.stats.n_dispatches, eng.stats.n_filler_slots) == \
        (dispatches, fillers)


def test_async_bit_identical_to_sync_and_backpressure():
    insts = _mixed_stream(10, seed=17)
    r_sync = _engine(batch_cap=4, max_inflight=0).solve_stream(insts)
    eng = _engine(batch_cap=4, max_inflight=4)
    r_async = eng.solve_stream(insts)
    assert eng.stats.inflight_high_water >= 1
    for a, b in zip(r_sync, r_async):
        _bitwise(a, b)
    eng = _engine(batch_cap=2, max_inflight=2, ready_fn=lambda tree: False)
    tickets = eng.submit_many([_small(s) for s in range(6)])
    assert eng.stats.n_dispatches == 3 and eng.inflight == 2
    assert tickets[0].done and not any(t.done for t in tickets[2:])
    eng.drain()
    assert all(t.done for t in tickets) and eng.inflight == 0


def test_harvest_waits_for_ready():
    gate = {"open": False}
    eng = _engine(batch_cap=2, max_inflight=8,
                  ready_fn=lambda tree: gate["open"] and api.tree_ready(tree))
    tickets = eng.submit_many([_small(s) for s in range(2)])
    assert eng.stats.n_dispatches == 1 and eng.inflight == 1
    assert eng.pump() == 0 and not any(t.done for t in tickets)
    gate["open"] = True
    assert eng.pump() == 0 and all(t.done for t in tickets)


def test_row_cap_tuning_bit_identical_and_adaptive_routing():
    insts = [_large(s) for s in range(4)]
    tuned = _engine(batch_cap=2, tune_short_cap=True).solve_stream(insts)
    plain = _engine(batch_cap=2, tune_short_cap=False).solve_stream(insts)
    for a, b in zip(tuned, plain):
        _bitwise(a, b)
    eng = _engine(batch_cap=2, adaptive_routing=True, min_route_samples=1)
    inst = _large(0)
    bucket = eng.policy.bucket_of(inst)
    assert eng.submit(inst).route.config.graph_impl == "sparse"  # static
    eng.stats.record_wall((bucket, ROUTE_D), 0.001, 2)
    eng.stats.record_wall((bucket, ROUTE_S), 5.0, 2)
    assert eng.submit(inst).route == ROUTE_D    # measured: dense faster


def _patch_for(inst, seed, cost=3.0):
    ev = inst.edge_valid.numpy()
    u, v = inst.u.numpy()[ev], inst.v.numpy()[ev]
    i = seed % len(u)
    return api.make_patch(inst.num_nodes,
                          reweight=([int(u[i])], [int(v[i])], [cost]),
                          device="cpu")


def _session_router():
    return Router(rules=[
        RoutingRule(route=Route(mode="pd", config=CFG_DELTA),
                    traffic="delta"),
        RoutingRule(route=Route(mode="pd", config=CFG_DENSE),
                    traffic="solve")])


def _inst(seed):
    return random_instance(14, 0.5, seed=seed, pad_edges=128, pad_nodes=16,
                           device="cpu")


def test_exact_session_ticks_equal_cold_solves():
    eng = _engine(router=_session_router(), batch_cap=4, patch_cap=4)
    inst = _inst(1)
    s = eng.open_session(inst, warm=False)
    assert s.route.config == CFG_DELTA
    padded = pad_instance(inst, s.bucket)
    cold0 = api.solve(padded, config=CFG_DELTA, device="cpu")
    assert torch.equal(s.last_result.objective, cold0.objective)
    for tick in range(3):
        patch = _patch_for(inst, tick, cost=2.0 + tick)
        res = eng.submit_delta(s.session_id, patch).result()
        padded = apply_patch_host(padded, patch)
        cold = api.solve(padded, config=CFG_DELTA, device="cpu")
        _bitwise(res, cold._replace(labels=cold.labels[:inst.num_nodes]))
    assert s.n_ticks == 3


def test_sessions_micro_batch_and_serialize():
    api.clear_cache()
    eng = _engine(router=_session_router(), batch_cap=4, patch_cap=4)
    insts = [_inst(s) for s in range(3)]
    sessions = [eng.open_session(i, warm=False) for i in insts]
    assert eng.stats.compiles == 1              # one delta-open entry
    tickets = [eng.submit_delta(s.session_id, _patch_for(i, 0))
               for s, i in zip(sessions, insts)]
    assert not any(t.done for t in tickets) and eng.pending == 3
    results = [t.result() for t in tickets]
    assert eng.stats.n_delta_dispatches == 1
    assert eng.stats.n_delta_filler_slots == 1
    assert eng.stats.compiles == 2              # + one batched delta entry
    for s, i, r in zip(sessions, insts, results):
        want = apply_patch_host(pad_instance(i, s.bucket), _patch_for(i, 0))
        assert torch.equal(s.state.instance.cost, want.cost)
        assert s.last_result is r
    t1 = eng.submit_delta(sessions[0].session_id, _patch_for(insts[0], 1))
    t2 = eng.submit_delta(sessions[0].session_id, _patch_for(insts[0], 2))
    assert t1.done                              # flushed by t2's admission
    t2.result()
    assert sessions[0].n_ticks == 3


def test_warm_session_and_errors():
    eng = _engine(router=_session_router(), batch_cap=2, patch_cap=2)
    inst = _inst(3)
    s = eng.open_session(inst)                  # warm by default
    patch = _patch_for(inst, 0, cost=-4.0)
    res = eng.submit_delta(s.session_id, patch).result()
    padded = apply_patch_host(pad_instance(inst, s.bucket), patch)
    assert float(res.objective) == pytest.approx(
        float(padded.objective(s.state.labels)), abs=1e-4)
    assert np.isfinite(float(res.lower_bound))
    assert float(res.lower_bound) <= float(res.objective) + 1e-4
    with pytest.raises(ValueError, match="primal"):
        eng.open_session(inst, route=Route(mode="d", config=CFG_DENSE))
    ev = inst.edge_valid.numpy()
    big = api.make_patch(inst.num_nodes, reweight=(
        inst.u.numpy()[ev][:3], inst.v.numpy()[ev][:3], [1.0, 2.0, 3.0]),
        device="cpu")
    with pytest.raises(ValueError, match="live entries"):
        eng.submit_delta(s.session_id, big)
    closed = eng.close_session(s.session_id)
    assert closed is s and s.session_id not in eng.sessions
    with pytest.raises(KeyError):
        eng.submit_delta(s.session_id, patch)


def test_lru_eviction_and_readmit():
    eng = _engine(router=_session_router(), batch_cap=4, patch_cap=4,
                  max_sessions=2)
    insts = [_inst(s) for s in range(3)]
    s0 = eng.open_session(insts[0], warm=False)
    s1 = eng.open_session(insts[1], warm=False)
    t0 = eng.submit_delta(s0.session_id, _patch_for(insts[0], 0))
    t1 = eng.submit_delta(s1.session_id, _patch_for(insts[1], 0))
    s2 = eng.open_session(insts[2], warm=False)
    assert eng.stats.n_sessions_evicted == 1 and t0.done
    assert s0.session_id not in eng.sessions
    assert s1.session_id in eng.sessions and s2.session_id in eng.sessions
    s0b = eng.open_session(insts[0], session_id=s0.session_id, warm=False)
    assert eng.stats.n_sessions_evicted == 2 and t1.done
    assert s0b is not s0 and s0b.n_ticks == 0
    res = eng.submit_delta(s0b.session_id, _patch_for(insts[0], 0)).result()
    assert np.isfinite(float(res.objective))


def test_metrics_spans_and_device():
    tracer = serve.engine.SpanRecorder()
    eng = _engine(batch_cap=2, tracer=tracer)
    eng.solve_stream([_small(0), _small(1), _large(0)])
    snap = eng.metrics_snapshot()
    assert snap["engine_requests_completed"]["value"] == 3
    assert snap["request_latency_seconds"]["count"] == 3
    assert "engine_occupancy" in eng.metrics_prometheus()
    names = {e["name"] for e in tracer.to_chrome_trace()["traceEvents"]}
    assert {"admit", "dispatch", "queued", "solve", "harvest"} <= names
    assert "device='cpu'" in repr(eng)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SolveEngine()


# ---------------------------------------------------------------------------
# a mixed stream against JAX's api.solve of the bucket-padded instances
# ---------------------------------------------------------------------------

def test_stream_matches_jax_solve_of_padded_instances():
    """Six requests over two bucket shapes on the dense route: each engine
    result against the JAX package's api.solve of its bucket-padded
    instance (one JAX compile per bucket shape)."""
    jinsts = [jg.random_instance(12, 0.5, seed=s, pad_edges=64,
                                 pad_nodes=16) for s in range(3)] + \
             [jg.random_instance(28, 0.4, seed=s, pad_edges=256,
                                 pad_nodes=32) for s in range(3)]
    tinsts = [instance_from_numpy(*[np.asarray(x) for x in i],
                                  device="cpu") for i in jinsts]
    eng = _engine(router=Router(default=ROUTE_D), batch_cap=4)
    results = eng.solve_stream(tinsts)
    assert len({eng.policy.bucket_of(i) for i in tinsts}) == 2
    jcfg = japi.SolverConfig(**dataclasses.asdict(CFG_DENSE))
    for ji, res in zip(jinsts, results):
        jb = jserve.BucketPolicy(node_floor=16, edge_floor=64).bucket_of(ji)
        want = jax.tree.map(np.asarray, japi.solve(
            jserve.pad_instance(ji, jb), mode="pd", config=jcfg))
        h = result_to_numpy(res)
        np.testing.assert_array_equal(h.labels,
                                      want.labels[:ji.num_nodes])
        for f in INTS[1:]:
            np.testing.assert_array_equal(getattr(h, f), getattr(want, f),
                                          err_msg=f)
        for f in ("objective", "lower_bound", "lb_history"):
            np.testing.assert_allclose(getattr(h, f), getattr(want, f),
                                       rtol=RTOL, err_msg=f)
