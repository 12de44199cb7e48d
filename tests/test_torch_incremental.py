"""The port's delta solves (``repro_torch.incremental`` and the api's
``solve_with_state``/``solve_delta``) against the JAX package's
``repro.incremental`` on the same numpy inputs.

Patches, their application and the frontier are integer bookkeeping and
copies of costs: held exactly (costs bitwise; the patch slack, a float
sum, within rtol 1e-6). An exact delta tick must equal the port's cold
solve of the patched instance bit for bit, and JAX's exact tick with
integers exact and floats within rtol 1e-5 (float32 sums reduced in
another order, as in tests/test_torch_solve.py). Warm ticks are held
against JAX's warm ticks on the same carried state the same way. All
instances share one padded shape, so JAX compiles once per data path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.incremental import patch as jpatch  # noqa: E402
from repro.incremental import solve as jsolve  # noqa: E402
from repro.incremental import state as jstate  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.convert import instance_from_numpy, result_to_numpy  # noqa: E402,E501
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.incremental import patch as tpatch  # noqa: E402
from repro_torch.incremental import solve as tsolve  # noqa: E402

RTOL = 1e-5
CFG = dict(max_neg=32, mp_iters=2, max_rounds=4)
PAD = dict(pad_nodes=256, pad_edges=1200)
INSTANCES = {
    "grid": lambda: jg.grid_instance(14, 14, seed=0, **PAD),
    "cluster": lambda: jg.cluster_instance(80, seed=3, **PAD),
}
INTS = ("labels", "rounds", "n_contracted", "n_clusters")
FLOATS = ("objective", "lower_bound", "lb_history")


def _np(x):
    return np.asarray(x)


def _port(ji):
    return instance_from_numpy(*[_np(x) for x in ji], device="cpu")


def _patch_args(ji, seed, n_rw=6, n_ins=5, n_del=4):
    """make_patch keyword arguments from a seed: reweights and deletes of
    distinct live edges, inserts of absent pairs among live nodes."""
    rng = np.random.default_rng(seed)
    ev = _np(ji.edge_valid)
    u, v = _np(ji.u)[ev], _np(ji.v)[ev]
    n = int(_np(ji.node_valid).sum())
    pick = rng.choice(len(u), size=n_rw + n_del, replace=False)
    rw, de = pick[:n_rw], pick[n_rw:]
    have = set(zip(u.tolist(), v.tolist()))
    ins = []
    while len(ins) < n_ins:
        a, b = sorted(rng.choice(n, size=2, replace=False).tolist())
        if (a, b) not in have:
            have.add((a, b))
            ins.append((a, b))
    ia, ib = np.array(ins).T
    return dict(reweight=(u[rw], v[rw],
                          rng.normal(0, 1.5, n_rw).astype(np.float32)),
                insert=(ib, ia, rng.normal(0, 1.5, n_ins).astype(np.float32)),
                delete=(u[de], v[de]))


def _both_patches(num_nodes, pad=None, **kw):
    return (jpatch.make_patch(num_nodes, pad_entries=pad, **kw),
            tpatch.make_patch(num_nodes, pad_entries=pad, device="cpu", **kw))


def _same_arrays(t, j, what=""):
    for f, x, y in zip(t._fields, t, j):
        np.testing.assert_array_equal(x.cpu().numpy(), _np(y),
                                      err_msg=f"{what}{f}")


def _to_jax_csr(csr):
    return jg.CsrGraph(*(jnp.asarray(x.cpu().numpy()) for x in csr))


# ---------------------------------------------------------------------------
# patches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["all-kinds", "deletes", "empty"])
def test_make_patch_matches_jax(case):
    ji = INSTANCES["grid"]()
    kw = _patch_args(ji, seed=1)
    if case == "deletes":
        kw = dict(delete=kw["delete"])
    elif case == "empty":
        kw = {}
    j, t = _both_patches(ji.num_nodes, pad=24, **kw)
    _same_arrays(t, j)
    assert t.num_entries == j.num_entries == 24


BAD = {
    "out of range": dict(delete=([0], [999])),
    "self-loop": dict(insert=([3], [3], [1.0])),
    "duplicate": dict(reweight=([1], [2], [1.0]), delete=([2], [1])),
    "shapes": dict(insert=([1, 2], [3], [1.0])),
    "capacity": dict(delete=([0, 1], [1, 2]), pad_entries=1),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_make_patch_validation_matches_jax(bad):
    kw = BAD[bad]
    with pytest.raises(ValueError) as je:
        jpatch.make_patch(16, **kw)
    with pytest.raises(ValueError) as te:
        tpatch.make_patch(16, device="cpu", **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("cap", [40, 15, 8])
def test_pad_patch_matches_jax(cap):
    ji = INSTANCES["grid"]()
    j, t = _both_patches(ji.num_nodes, pad=15, **_patch_args(ji, seed=2))
    if cap < 15:
        with pytest.raises(ValueError, match="live entries past"):
            jpatch.pad_patch(j, cap)
        with pytest.raises(ValueError, match="live entries past"):
            tpatch.pad_patch(t, cap)
        return
    _same_arrays(tpatch.pad_patch(t, cap), jpatch.pad_patch(j, cap))


_japply = jax.jit(jpatch.apply_patch)


def _apply_both(ji, jcsr, ti, tcsr, j_p, t_p):
    ji2, jcsr2, jinfo = _japply(ji, jcsr, j_p)
    ti2, tcsr2, tinfo = tpatch.apply_patch(ti, tcsr, t_p)
    _same_arrays(ti2, ji2, "instance.")
    _same_arrays(tcsr2, jcsr2, "csr.")
    for f in ("n_inserted", "n_deleted", "n_reweighted", "n_dropped"):
        assert int(getattr(tinfo, f)) == int(getattr(jinfo, f)), f
    np.testing.assert_allclose(float(tinfo.lb_slack), float(jinfo.lb_slack),
                               rtol=1e-6)
    # the spliced CSR is a fresh build; the host reference is slot-exact
    _same_arrays(tcsr2, tg.csr_from_instance(ti2), "rebuilt.")
    _same_arrays(tpatch.apply_patch_host(ti, t_p), ji2, "host.")
    return ji2, jcsr2, ti2, tcsr2, tinfo


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_apply_patch_matches_jax(name):
    ji = INSTANCES[name]()
    ti = _port(ji)
    j_p, t_p = _both_patches(ji.num_nodes, pad=20, **_patch_args(ji, 4))
    *_, info = _apply_both(ji, jg.csr_from_instance(ji), ti,
                           tg.csr_from_instance(ti), j_p, t_p)
    assert (int(info.n_inserted), int(info.n_deleted),
            int(info.n_reweighted), int(info.n_dropped)) == (5, 4, 6, 0)


def test_chained_patches_and_dropped_inserts_match_jax():
    """Three ticks in a row on a nearly full instance: the last one's
    inserts run out of free slots and are dropped alike."""
    ji = jg.grid_instance(10, 10, seed=5, pad_edges=352, pad_nodes=128)
    ti = _port(ji)
    jcsr, tcsr = jg.csr_from_instance(ji), tg.csr_from_instance(ti)
    for step, n_ins in enumerate((3, 6, 12)):
        kw = _patch_args(ji, 10 + step, n_rw=4, n_ins=n_ins, n_del=2)
        j_p, t_p = _both_patches(ji.num_nodes, pad=24, **kw)
        ji, jcsr, ti, tcsr, info = _apply_both(ji, jcsr, ti, tcsr, j_p, t_p)
    assert int(info.n_dropped) > 0


@pytest.mark.parametrize("halo", [0, 1, 2])
def test_patch_frontier_matches_jax(halo):
    ji = INSTANCES["cluster"]()
    j_p, t_p = _both_patches(ji.num_nodes, pad=16,
                             **_patch_args(ji, 6, n_rw=2, n_ins=1, n_del=1))
    t = tsolve.patch_frontier(_port(ji), t_p, halo)
    j = jsolve.patch_frontier(ji, j_p, halo)
    np.testing.assert_array_equal(t.numpy(), _np(j))
    assert t.sum() > 0


@pytest.mark.parametrize("lb", [1.5, float("-inf"), float("nan")])
def test_carriable_bound_matches_jax(lb):
    t = tsolve._carriable_bound(torch.tensor(lb))
    j = jsolve._carriable_bound(jnp.float32(lb))
    np.testing.assert_array_equal(t.numpy(), _np(j))


# ---------------------------------------------------------------------------
# delta solves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_exact():
    """JAX exact ticks from a fresh state, one compile per data path."""
    cache = {}

    def get(name, impl):
        if (name, impl) not in cache:
            ji = INSTANCES[name]()
            j_p = jpatch.make_patch(ji.num_nodes, pad_entries=20,
                                    **_patch_args(ji, 7))
            cfg = japi.SolverConfig(graph_impl=impl, **CFG)
            res, _ = japi.solve_delta(jstate.init_delta_state(ji), j_p,
                                      config=cfg)
            cache[name, impl] = jax.tree.map(np.asarray, res)
        return cache[name, impl]
    return get


@pytest.mark.parametrize("impl", ["dense", "sparse"])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_exact_delta_equals_cold_and_jax(name, impl, jax_exact):
    ji = INSTANCES[name]()
    ti = _port(ji)
    cfg = tapi.SolverConfig(graph_impl=impl, **CFG)
    t_p = tpatch.make_patch(ti.num_nodes, pad_entries=20, device="cpu",
                            **_patch_args(ji, 7))
    opened, state = tapi.solve_with_state(ti, config=cfg, device="cpu")
    for f, x, y in zip(opened._fields, opened,
                       tapi.solve(ti, config=cfg, device="cpu")):
        assert torch.equal(x, y), f
    res, state2 = tapi.solve_delta(state, t_p, config=cfg, device="cpu")
    cold = tapi.solve(tpatch.apply_patch_host(ti, t_p), config=cfg,
                      device="cpu")
    for f, x, y in zip(res._fields, res, cold):
        assert torch.equal(x, y), f
    assert torch.equal(state2.labels, res.labels)
    assert bool(state2.has_solution)
    for f, x, y in zip(state2.csr._fields, state2.csr,
                       tg.csr_from_instance(state2.instance)):
        assert torch.equal(x, y), f
    h, j = result_to_numpy(res), jax_exact(name, impl)
    for f in INTS:
        np.testing.assert_array_equal(getattr(h, f), getattr(j, f),
                                      err_msg=f)
    for f in FLOATS:
        np.testing.assert_allclose(getattr(h, f), getattr(j, f), rtol=RTOL,
                                   err_msg=f)


def test_warm_ticks_match_jax():
    """Two warm ticks on the grid instance (dense path), each from the
    same carried state in both packages: integers exact, objective and
    carried bound within rtol 1e-5; the objective is the float64 recount
    of the labels and the carried bound stays below it."""
    ji = INSTANCES["grid"]()
    ti = _port(ji)
    cfg_kw = dict(graph_impl="dense", **CFG)
    tcfg, jcfg = tapi.SolverConfig(**cfg_kw), japi.SolverConfig(**cfg_kw)
    _, state = tapi.solve_with_state(ti, config=tcfg, device="cpu")
    for tick in range(2):
        kw = _patch_args(ji, 20 + tick)
        j_p, t_p = _both_patches(ji.num_nodes, pad=20, **kw)
        jst = jstate.DeltaState(
            instance=jg.MulticutInstance(*(jnp.asarray(x.numpy())
                                           for x in state.instance)),
            csr=_to_jax_csr(state.csr),
            labels=jnp.asarray(state.labels.numpy()),
            has_solution=jnp.bool_(bool(state.has_solution)),
            lower_bound=jnp.float32(float(state.lower_bound)))
        jres, jst2 = japi.solve_delta(jst, j_p, config=jcfg, warm=True)
        res, state = tapi.solve_delta(state, t_p, config=tcfg, warm=True,
                                      device="cpu")
        h, j = result_to_numpy(res), jax.tree.map(np.asarray, jres)
        for f in INTS:
            np.testing.assert_array_equal(getattr(h, f), getattr(j, f),
                                          err_msg=f"tick {tick} {f}")
        for f in FLOATS:
            np.testing.assert_allclose(getattr(h, f), getattr(j, f),
                                       rtol=RTOL, err_msg=f"tick {tick} {f}")
        inst2 = state.instance
        lab = state.labels.numpy()
        cut = inst2.edge_valid.numpy() & (lab[inst2.u.numpy()]
                                          != lab[inst2.v.numpy()])
        obj64 = inst2.cost.numpy().astype(np.float64)[cut].sum()
        np.testing.assert_allclose(float(res.objective), obj64, rtol=RTOL)
        assert float(res.lower_bound) <= float(res.objective)
        ji = jst2.instance


def test_warm_mode_d_raises():
    ti = tg.grid_instance(5, 5, seed=0, pad_edges=150, device="cpu")
    t_p = tpatch.make_patch(ti.num_nodes, delete=([0], [1]), device="cpu")
    _, state = tapi.solve_with_state(ti, mode="d", device="cpu")
    assert not bool(state.has_solution)
    with pytest.raises(ValueError, match="mode 'd'"):
        tapi.solve_delta(state, t_p, mode="d", warm=True, device="cpu")
    with pytest.raises(ValueError, match="mode 'd'"):
        tsolve.solve_delta_device(state, t_p, mode="d", warm=True)
    with pytest.raises(ValueError, match="warm-start seeds"):
        tsolve.solve_device(ti, cfg=tapi.SolverConfig(state_shards=2),
                            csr=state.csr)


@pytest.mark.parametrize("mode", ["p", "d", "pd+"])
def test_exact_delta_other_modes_equal_cold(mode):
    ti = tg.grid_instance(9, 9, seed=2, pad_edges=400, device="cpu")
    cfg = tapi.SolverConfig(graph_impl="sparse", **CFG)
    ji = jg.grid_instance(9, 9, seed=2, pad_edges=400)
    t_p = tpatch.make_patch(ti.num_nodes, device="cpu",
                            **_patch_args(ji, 8, n_rw=3, n_ins=2, n_del=2))
    _, state = tapi.solve_with_state(ti, mode=mode, config=cfg,
                                     device="cpu")
    res, state2 = tapi.solve_delta(state, t_p, mode=mode, config=cfg,
                                   device="cpu")
    cold = tapi.solve(tpatch.apply_patch_host(ti, t_p), mode=mode,
                      config=cfg, device="cpu")
    for f, x, y in zip(res._fields, res, cold):
        assert torch.equal(x, y), f
    assert bool(state2.has_solution) == (mode != "d")
