"""The port's solve trace (``api.solve(trace=True)``, ``repro_torch.obs.
trace``) against the JAX package's, after ``tests/test_obs_trace.py``
(the sharded case waits for the sharded solve).

Tracing is strictly additive: a traced solve returns every result leaf
bit for bit equal to the untraced one, in every mode on both data paths.
The trace's rows match the reference's: integer rows exactly, the bound
and objective rows within rtol 1e-5 (torch and XLA reduce floats in
different orders). The MP-gain row is the difference of two such sums
(LB − Σ min(0, c)), each of the bound's magnitude, so its error is held
relative to that magnitude: within 1e-5 × max |LB|.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.convert import instance_from_numpy  # noqa: E402
from repro_torch.obs import (SolveTrace, init_trace, summarize,  # noqa: E402
                             trace_set_round)

CFG = tapi.SolverConfig(max_neg=128, max_tri_per_edge=8, nbr_k=8,
                        mp_iters=4)
JCFG = japi.SolverConfig(max_neg=128, max_tri_per_edge=8, nbr_k=8,
                         mp_iters=4)
MODES = ("p", "pd", "pd+", "d")
RTOL = 1e-5
INTS = ("rounds", "n_cycles", "n_contracted", "n_clusters", "shard_edges",
        "shard_topk", "shard_halo")
FLOATS = ("lower_bound", "objective")
# (mode, data path) pairs held against the reference's trace: all eight
REF_CASES = [(m, i) for m in MODES for i in ("dense", "sparse")]


def _jinst():
    return jg.random_instance(40, 0.2, seed=0, pad_edges=512, pad_nodes=64)


def _inst():
    return instance_from_numpy(*[np.asarray(x) for x in _jinst()],
                               device="cpu")


def _cfg(impl):
    return dataclasses.replace(CFG, graph_impl=impl)


@pytest.fixture(scope="module")
def ref_traces():
    """The reference's traced solves, made once for the module."""
    ji = _jinst()
    out = {}
    for mode, impl in REF_CASES:
        _, jtr = japi.solve(ji, mode=mode, trace=True,
                            config=dataclasses.replace(JCFG,
                                                       graph_impl=impl))
        out[mode, impl] = {k: np.asarray(v) for k, v in
                           jtr._asdict().items()}
    return out


def _bit_eq(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.numpy().tobytes() == y.numpy().tobytes(), (x, y)


@pytest.mark.parametrize("impl", ["dense", "sparse"])
@pytest.mark.parametrize("mode", MODES)
def test_traced_solve_is_bitwise_identical(mode, impl):
    inst = _inst()
    ref = tapi.solve(inst, mode=mode, config=_cfg(impl), device="cpu")
    res, tr = tapi.solve(inst, mode=mode, config=_cfg(impl), trace=True,
                         device="cpu")
    _bit_eq(res, ref)
    assert isinstance(tr, SolveTrace)
    assert int(tr.rounds) >= 1
    assert all(x.device.type == "cpu" for x in tr)


@pytest.mark.parametrize("mode,impl", REF_CASES)
def test_trace_rows_match_reference(mode, impl, ref_traces):
    """Every leaf of the port's trace against the reference's: same
    structure and shapes; integer rows exact; bound and objective within
    rtol 1e-5 (padding sentinels equal), the MP gain within 1e-5 of the
    bound's magnitude (see the module docstring)."""
    _, tr = tapi.solve(_inst(), mode=mode, config=_cfg(impl), trace=True,
                       device="cpu")
    want = ref_traces[mode, impl]
    assert tuple(want) == SolveTrace._fields
    got = {k: v.numpy() for k, v in tr._asdict().items()}
    for k in INTS:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in FLOATS:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                   err_msg=f"{mode} {impl} {k}")
    scale = np.abs(want["lower_bound"][np.isfinite(want["lower_bound"])])
    np.testing.assert_allclose(
        got["mp_improvement"], want["mp_improvement"], rtol=0,
        atol=RTOL * float(scale.max(initial=0.0)),
        err_msg=f"{mode} {impl} mp_improvement")


def test_trace_registry_entries_are_separate():
    inst = _inst()
    tapi.clear_cache()
    tapi.solve(inst, mode="pd", config=CFG, device="cpu")
    m0, t0 = tapi.cache_info().misses, tapi.trace_count()
    tapi.solve(inst, mode="pd", config=CFG, trace=True, device="cpu")
    assert tapi.cache_info().misses == m0 + 1          # its own entry
    assert tapi.trace_count() == t0 + 1                # its own first call
    h0 = tapi.cache_info().hits
    tapi.solve(inst, mode="pd", config=CFG, device="cpu")
    tapi.solve(inst, mode="pd", config=CFG, trace=True, device="cpu")
    assert tapi.cache_info().hits == h0 + 2
    assert tapi.trace_count() == t0 + 1
    fn = tapi.compiled_solve("pd", CFG, trace=True)
    assert fn is tapi.compiled_solve("pd", CFG, trace=True)
    assert fn is not tapi.compiled_solve("pd", CFG)
    res, tr = fn(inst)
    _bit_eq(res, tapi.solve(inst, mode="pd", config=CFG, device="cpu"))
    mc = tapi.Multicut("pd", config=CFG, device="cpu")
    res2, tr2 = mc.solve(inst, trace=True)
    _bit_eq(tr2, tr)
    with pytest.raises(ValueError, match="kind='solve'"):
        tapi._compiled("pd", CFG, "cuda", False, 1, "delta", True)


def test_trace_rows_are_live_then_padding():
    res, tr = tapi.solve(_inst(), mode="pd", config=CFG, trace=True,
                         device="cpu")
    R = int(tr.rounds)
    assert R == int(res.rounds) and 1 <= R <= CFG.max_rounds
    assert tr.lower_bound.shape == (CFG.max_rounds,)
    assert tr.shard_edges.shape == (CFG.max_rounds, 1)   # unsharded: S=1
    lb, obj = tr.lower_bound.numpy(), tr.objective.numpy()
    assert np.all(np.isfinite(lb[:R])) and np.all(np.isfinite(obj[:R]))
    assert np.all(lb[R:] == -np.inf) and np.all(obj[R:] == np.inf)
    assert np.all(lb[:R] <= obj[:R] + 1e-4)
    np.testing.assert_array_equal(lb[:R], res.lb_history.numpy()[:R])
    assert obj[R - 1] == float(res.objective)
    nc = tr.n_clusters.numpy()[:R]
    assert np.all(tr.n_cycles.numpy()[:R] >= 0)
    assert np.all(tr.n_contracted.numpy()[:R] >= 0)
    assert np.all(nc[:-1] >= nc[1:])


def test_dual_mode_trace_has_lb_no_contraction():
    res, tr = tapi.solve(_inst(), mode="d", config=CFG, trace=True,
                         device="cpu")
    R = int(tr.rounds)
    assert R == CFG.dual_rounds
    lb = tr.lower_bound.numpy()[:R]
    assert np.all(np.isfinite(lb))
    np.testing.assert_array_equal(lb, res.lb_history.numpy())
    assert np.all(tr.n_contracted.numpy()[:R] == 0)
    assert np.all(tr.objective.numpy() == np.inf)


def test_summarize_matches_result():
    res, tr = tapi.solve(_inst(), mode="pd", config=CFG, trace=True,
                         device="cpu")
    s = summarize(tr)
    assert s["rounds"] == int(tr.rounds) == len(s["per_round"])
    assert s["objective"]["final"] == pytest.approx(float(res.objective))
    assert s["lower_bound"]["best"] <= s["objective"]["best"] + 1e-4
    assert s["gap"] == pytest.approx(
        s["objective"]["final"] - s["lower_bound"]["best"])
    assert s["total_contracted"] == int(
        tr.n_contracted.numpy()[:s["rounds"]].sum())
    assert "shard_balance" not in s
    assert "shard_edges" not in s["per_round"][0]


def test_summarize_handles_padding_and_empty():
    empty = init_trace(4, shards=2, device="cpu")
    assert summarize(empty) == {"rounds": 0, "per_round": []}
    tr = trace_set_round(empty, 0, lower_bound=-3.0, objective=5.0,
                         n_cycles=7, n_contracted=2, n_clusters=9,
                         shard_edges=[6, 2], shard_topk=[4, 4],
                         shard_halo=[0, 0])
    s = summarize(tr)
    assert s["rounds"] == 1
    assert s["per_round"][0]["lower_bound"] == -3.0
    assert s["per_round"][0]["shard_edges"] == [6, 2]
    assert s["gap"] == pytest.approx(8.0)
    bal = s["shard_balance"]
    assert bal["edges"]["max_imbalance"] == pytest.approx(6 / 4)
    assert bal["topk"]["max_imbalance"] == pytest.approx(1.0)
    assert bal["halo"]["max_imbalance"] == pytest.approx(1.0)  # 0 total


def test_init_trace_defaults_to_cuda():
    """Like every entry point of the port, ``init_trace`` puts its trace
    on ``cuda`` unless told otherwise, and raises with no card."""
    if torch.cuda.is_available():
        assert init_trace(2).rounds.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            init_trace(2)
    assert init_trace(2, device="cpu").rounds.device.type == "cpu"


def test_trace_set_round_bumps_rounds_monotonically():
    tr = init_trace(4, device="cpu")
    tr = trace_set_round(tr, 2, lower_bound=1.0)
    assert int(tr.rounds) == 3
    tr = trace_set_round(tr, 0, lower_bound=torch.tensor(2.0))
    assert int(tr.rounds) == 3                       # earlier row: no shrink
    assert float(tr.lower_bound[0]) == 2.0
    assert math.isinf(float(tr.lower_bound[1]))
    assert tr.rounds.dtype == torch.int32
