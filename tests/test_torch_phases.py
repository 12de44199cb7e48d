"""The solve path's spans and counters (``repro_torch.obs.phase``,
``solver_spans``, ``solver_metrics``).

Tracing adds only reads: a solve traced by ``obs.solver_tracing()`` is bit
for bit the untraced one in every mode on both data paths. The span tree
has one ``solve``, a ``round`` a round with its index, and each phase
under its parent and inside it in time; under ``torch.profiler`` the
``contraction`` spans sit on the ``repro.contraction`` ranges, on the
profiler's own clock, and the set of ``repro.*`` ranges a round is the
one the benchmark reads. The connected-components steps equal an
independent count. With tracing off nothing is recorded, while the sync
counter still counts; a CPU solve waits for no card and counts no sync.
The recorder starts each stretch of tracing empty and counts what it
drops. On the card (``-m cuda``), the sync counter's sites of one solve
add up to what torch's sync debug mode counts, and the CUDA-timed spans
carry device times. This file imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_phases.py
"""
import dataclasses
import math
import warnings
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import api, obs  # noqa: E402
from repro_torch.core import contraction as tc  # noqa: E402
from repro_torch.core.graph import grid_instance  # noqa: E402
from repro_torch.obs import phases  # noqa: E402

MODES = ("p", "pd", "pd+", "d")
IMPLS = ("dense", "sparse")
PHASES = {"p": ("contraction",), "d": ("separation", "message_passing"),
          "pd": ("separation", "message_passing", "contraction"),
          "pd+": ("separation", "message_passing", "contraction")}
# name -> the names its parent may have
PARENT = {"round": ("solve",), "separation": ("round",),
          "message_passing": ("round",), "contraction": ("round",),
          "contraction.forest": ("contraction",),
          "contraction.cc": ("contraction.forest", "contraction")}
CC_SITE = {"contraction.forest": ("forest_try", "forest_keep"),
           "contraction": ("merge",)}


def _inst(device="cpu"):
    return grid_instance(12, 16, seed=3, device=device)


def _cfg(impl):
    return dataclasses.replace(api.SolverConfig(), graph_impl=impl)


def _solve(mode, impl, device="cpu", inst=None):
    inst = _inst(device) if inst is None else inst
    return api.solve(inst, mode=mode, config=_cfg(impl), device=device)


def _traced(mode, impl, device="cpu"):
    """A solve under ``solver_tracing`` and the spans it left."""
    rec = obs.solver_spans()
    rec.clear()
    with obs.solver_tracing():
        res = _solve(mode, impl, device)
    return res, obs.solver_spans().spans


def _counters():
    return {k: v["value"] for k, v in obs.solver_metrics().snapshot().items()}


def _change(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _bit_eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", MODES)
def test_traced_solve_is_bitwise_identical(mode, impl):
    plain = _solve(mode, impl)
    traced, spans = _traced(mode, impl)
    _bit_eq(plain, traced)
    assert [s.name for s in spans].count("solve") == 1


@pytest.mark.parametrize("mode", MODES)
def test_span_tree_shape(mode):
    before = _counters()
    res, spans = _traced(mode, "sparse")
    change = _change(before, _counters())
    rounds = int(res.rounds)
    (solve,) = [s for s in spans if s.name == "solve"]
    assert spans[0] is solve and solve.args["parent"] is None
    assert solve.args["mode"] == mode
    assert solve.args["nodes"] == 192 and solve.args["slots"] > 0
    assert solve.args["counters"] == change == {}    # no card waited for
    rnd = [s for s in spans if s.name == "round"]
    assert [s.args["r"] for s in rnd] == list(range(rounds))
    assert all(s.args["slots"] == solve.args["slots"] for s in rnd)
    assert rnd[0].args["live_edges"] == int(_inst().edge_valid.sum())
    for s in spans:
        assert s.tid == solve.tid and s.dur_s is not None
        if s is solve:
            continue
        up = spans[s.args["parent"]]
        assert up.name in PARENT[s.name], (s.name, up.name)
        assert up.t0_s <= s.t0_s and \
            s.t0_s + s.dur_s <= up.t0_s + up.dur_s, s.name
        assert s.args["r"] == (up.args.get("r") if s.name != "round"
                               else s.args["r"])
        if s.name == "contraction.cc":
            assert s.args["site"] in CC_SITE[up.name]
    for r, s in enumerate(rnd):
        kids = [k.name for k in spans if k.args["parent"] == spans.index(s)]
        assert tuple(kids) == PHASES[mode], (r, kids)
    if "contraction" in PHASES[mode]:
        forest = [s for s in spans if s.name == "contraction.forest"]
        assert len(forest) == rounds
        assert all(isinstance(s.args["used"], bool) for s in forest)


def test_contraction_spans_sit_on_their_profiler_ranges():
    """The spans' host clock is the profiler's: each in-memory
    ``contraction`` span and its ``repro.contraction`` range agree within
    100 us at both ends; every round opens the same three ``repro.*``
    ranges once, and nothing else opens a ``repro.*`` or ``bench.*``
    range."""
    _solve("pd", "sparse")
    obs.solver_spans().clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _solve("pd", "sparse")
    spans = obs.solver_spans().spans
    rounds = int(res.rounds)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("repro.", "bench."))]
    assert Counter(e.name() for e in events) == {
        "repro.separation": rounds, "repro.message_passing": rounds,
        "repro.contraction": rounds}
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in events if e.name() == "repro.contraction")
    con = [s for s in spans if s.name == "contraction"]
    assert len(con) == len(ranges) == rounds
    for s, (a, b) in zip(con, ranges):
        assert abs(s.t0_s * 1e9 - a) < 100e3, (s.t0_s * 1e9 - a)
        assert abs((s.t0_s + s.dur_s) * 1e9 - b) < 100e3, \
            ((s.t0_s + s.dur_s) * 1e9 - b)


def _plain_cc_steps(u, v, mask, n):
    """Steps of min-label propagation with two pointer jumps that change
    the labels, checked after every step (the reference's loop)."""
    labels = torch.arange(n, dtype=torch.int32)
    ul, vl = u.long(), v.long()
    k = 0
    while True:
        lu, lv = labels[ul], labels[vl]
        m = torch.minimum(lu, lv)
        new = labels.scatter_reduce(0, ul, torch.where(mask, m, lu), "amin")
        new = new.scatter_reduce(0, vl, torch.where(mask, m, lv), "amin")
        new = new[new.long()]
        new = new[new.long()]
        if torch.equal(new, labels):
            return k
        labels = new
        k += 1


def test_cc_counts_match_an_independent_count(monkeypatch):
    calls = []
    orig = tc.connected_components

    def noted(u, v, mask, n, site="other"):
        calls.append((site, u.clone(), v.clone(), mask.clone(), n))
        return orig(u, v, mask, n, site=site)

    monkeypatch.setattr(tc, "connected_components", noted)
    monkeypatch.setattr(phases, "SYNC_DEVICES", ("cuda", "cpu"))
    before = _counters()
    _, spans = _traced("pd", "sparse")
    change = _change(before, _counters())
    cc = [s for s in spans if s.name == "contraction.cc"]
    assert len(cc) == len(calls) > 0
    checks = 0
    for s, (site, u, v, mask, n) in zip(cc, calls):
        k = _plain_cc_steps(u, v, mask, n)
        assert s.args["site"] == site
        # one check a block of CC_CHECK_EVERY steps; the last block
        # changes nothing
        checks += math.ceil(k / tc.CC_CHECK_EVERY) + 1
        assert s.args["steps"] == \
            tc.CC_CHECK_EVERY * (math.ceil(k / tc.CC_CHECK_EVERY) + 1)
        if k:
            assert s.args["steps"] >= 8
    assert {s.args["site"] for s in cc} == {"forest_try", "forest_keep",
                                            "merge"}
    assert change["solver_syncs_total.cc_check"] == checks


def test_tracing_off_records_nothing_while_counters_count(monkeypatch):
    """Off, a phase is the shared no-op and the recorder stays empty. The
    sync counter counts all the same, at every site where a card would be
    waited for (here the CPU's reads stand in for a card's); a CPU solve
    itself waits for nothing and counts nothing."""
    rec = obs.solver_spans()
    rec.clear()
    assert not obs.tracing()
    assert obs.phase("round", r=0) is obs.phase("contraction.forest")
    assert not obs.phase("separation", range="repro.separation")
    before = _counters()
    _solve("pd", "sparse")
    assert _change(before, _counters()) == {}
    monkeypatch.setattr(phases, "SYNC_DEVICES", ("cuda", "cpu"))
    before = _counters()
    res = _solve("pd", "sparse")
    change = _change(before, _counters())
    assert len(rec) == 0 and rec.n_dropped == 0
    rounds = int(res.rounds)
    assert change["solver_syncs_total.round_exit"] == rounds
    assert change["solver_syncs_total.run_sum_len"] == rounds
    assert change["solver_syncs_total.result_scalar"] == 1
    # two CC calls a forest round, one a merge, each at least one check
    assert change["solver_syncs_total.cc_check"] >= \
        rounds * (2 * api.SolverConfig().forest_rounds + 1)
    assert set(change) <= {f"{phases.SYNCS}.{k}" for k in (
        "round_exit", "run_sum_len", "result_scalar", "cc_check",
        "long_bucket")}


def test_recorder_counts_what_it_drops():
    rec = obs.solver_spans()
    rec.clear()
    cap = rec.max_events
    rec.max_events = 5
    try:
        with obs.solver_tracing():
            _solve("p", "sparse")
        spans = obs.solver_spans().spans
        assert len(spans) == 5 and rec.n_dropped > 0
        assert [s.name for s in spans[:2]] == ["solve", "round"]
    finally:
        rec.max_events = cap
        rec.clear()


def test_each_stretch_of_tracing_starts_empty():
    """The first phase after tracing was off empties the recorder, so a
    profiler session after a traced block (or a block after a session)
    holds its own solves alone; phases inside one stretch accumulate."""
    with obs.solver_tracing():
        _solve("p", "sparse")
        _solve("p", "sparse")
    names = [s.name for s in obs.solver_spans().spans]
    assert names.count("solve") == 2
    _solve("p", "sparse")                       # off: recorder kept
    assert [s.name for s in obs.solver_spans().spans] == names
    with profile(activities=[ProfilerActivity.CPU]):
        _solve("p", "sparse")
    spans = obs.solver_spans().spans
    assert [s.name for s in spans].count("solve") == 1
    assert spans[0].name == "solve" and spans[0].args["parent"] is None
    with obs.solver_tracing():
        _solve("p", "sparse")
    assert [s.name for s in obs.solver_spans().spans].count("solve") == 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (host syncs exist only on a card)")
    return torch.device("cuda")


def _debug_mode_syncs(fn) -> int:
    """Synchronising CUDA calls during ``fn``, as torch's sync debug mode
    reports them ("called a synchronizing CUDA operation"). The mode's
    own first-use notice, that it is a prototype and does not yet detect
    all synchronizing operations, is no sync and is not counted."""
    n = [0]

    def note(message, *_):
        text = str(message)
        if "synchronizing" in text and "debug mode" not in text:
            n[0] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return n[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,impl", [("p", "sparse"), ("pd", "sparse"),
                                       ("pd+", "sparse"), ("d", "sparse"),
                                       ("pd", "dense")])
def test_sync_sites_add_up_to_sync_debug_mode(cuda_device, mode, impl):
    inst = grid_instance(24, 32, seed=5, device=cuda_device)
    _solve(mode, impl, cuda_device, inst)       # builds the kernels
    torch.cuda.synchronize()
    before = _counters()
    seen = _debug_mode_syncs(lambda: _solve(mode, impl, cuda_device, inst))
    torch.cuda.synchronize()
    sites = {k: v for k, v in _change(before, _counters()).items()
             if k.startswith("solver_syncs_total.")}
    assert sum(sites.values()) == seen, sites


@pytest.mark.cuda
def test_spans_on_the_card_carry_device_times(cuda_device):
    inst = grid_instance(24, 32, seed=5, device=cuda_device)
    plain = _solve("pd", "sparse", cuda_device, inst)
    obs.solver_spans().clear()
    with obs.solver_tracing():
        traced = _solve("pd", "sparse", cuda_device, inst)
    spans = obs.solver_spans().spans
    _bit_eq(plain, traced)
    timed = [s for s in spans if s.name in phases.TIMED]
    assert timed and all(s.args["device_ms"] >= 0 for s in timed)
    assert not any("device_ms" in s.args for s in spans
                   if s.name not in phases.TIMED)
    (solve,) = [s for s in spans if s.name == "solve"]
    cc = sum(s.args["device_ms"] for s in spans if s.name == "contraction.cc")
    assert 0 < cc <= solve.args["device_ms"]
    assert all(isinstance(s.args["live_edges"], int)
               for s in spans if s.name == "round")
