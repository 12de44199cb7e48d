"""The port's batch and registry entry points (``repro_torch.api``:
``solve_batch``, ``stack_instances``, ``unstack_results``, the bounded
registry with ``trace_count``/``cache_info``/``set_cache_maxsize``/
``clear_cache``, ``tree_ready``) against per-instance solves and against
the JAX package's ``solve_batch`` (one vmapped compile).

A batched port call solves slot by slot, so each slot must equal the
unbatched port solve bit for bit. Against JAX: integer outputs exact; the
objective, lower bound and its history within rtol 1e-5 (float32 sums
reduced in another order, as in tests/test_torch_solve.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.convert import instance_from_numpy, result_to_numpy  # noqa: E402,E501
from repro_torch.core import dist as tdist  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

RTOL = 1e-5
CFG = dict(max_neg=32, mp_iters=2, max_rounds=4)
PAD = dict(pad_nodes=64, pad_edges=512)
INTS = ("labels", "rounds", "n_contracted", "n_clusters")
FLOATS = ("objective", "lower_bound", "lb_history")


def _jax_instances():
    return [jg.random_instance(40, 0.15, seed=0, **PAD),
            jg.grid_instance(7, 8, seed=1, **PAD),
            jg.cluster_instance(45, seed=2, **PAD)]


def _port(ji):
    return instance_from_numpy(*[np.asarray(x) for x in ji], device="cpu")


def _bitwise(a, b):
    for f, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f


@pytest.fixture(scope="module")
def jax_batch():
    """JAX's vmapped solve_batch of the three instances, made once."""
    insts = _jax_instances()
    cfg = japi.SolverConfig(**CFG)
    res = japi.solve_batch(japi.stack_instances(insts), config=cfg)
    return insts, [jax.tree.map(np.asarray, r)
                   for r in japi.unstack_results(res)]


def test_solve_batch_equals_jax_and_per_instance(jax_batch):
    jinsts, jres = jax_batch
    insts = [_port(i) for i in jinsts]
    cfg = tapi.SolverConfig(**CFG)
    batch = tapi.stack_instances(insts)
    out = tapi.unstack_results(tapi.solve_batch(batch, config=cfg,
                                                device="cpu"))
    assert len(out) == 3
    for inst, r, j in zip(insts, out, jres):
        _bitwise(r, tapi.solve(inst, config=cfg, device="cpu"))
        h = result_to_numpy(r)
        for f in INTS:
            np.testing.assert_array_equal(getattr(h, f), getattr(j, f),
                                          err_msg=f)
        for f in FLOATS:
            np.testing.assert_allclose(getattr(h, f), getattr(j, f),
                                       rtol=RTOL, err_msg=f)


@pytest.mark.parametrize("mode", ["p", "pd+", "d"])
@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_solve_batch_slots_bitwise(mode, impl):
    """Every mode on both data paths: slot b of the batch is the
    unbatched solve of instance b, bit for bit (the facade too)."""
    insts = [_port(i) for i in _jax_instances()]
    mc = tapi.Multicut(mode=mode, config=tapi.SolverConfig(**CFG),
                       graph_impl=impl, device="cpu")
    out = tapi.unstack_results(mc.solve_batch(tapi.stack_instances(insts)))
    for inst, r in zip(insts, out):
        _bitwise(r, mc.solve(inst))


def test_stack_and_unstack_round_trip():
    insts = [_port(i) for i in _jax_instances()]
    batch = tapi.stack_instances(insts)
    assert batch.u.shape == (3, PAD["pad_edges"])
    assert batch.node_valid.shape == (3, PAD["pad_nodes"])
    for b, inst in enumerate(insts):
        _bitwise(tapi.MulticutInstance(*(x[b] for x in batch)), inst)
    res = tapi.solve_batch(batch, config=tapi.SolverConfig(**CFG),
                           device="cpu")
    again = tapi.unstack_results(res)
    assert all(r.labels.shape == (PAD["pad_nodes"],) for r in again)
    for f, x in zip(res._fields, res):
        assert torch.equal(torch.stack([getattr(r, f) for r in again]), x)
    with pytest.raises(ValueError, match="share padded shapes"):
        tapi.stack_instances([insts[0], tg.grid_instance(3, 3,
                                                          device="cpu")])
    with pytest.raises(ValueError, match="at least one"):
        tapi.stack_instances([])


def test_registry_keys_match_jax():
    """The same sequence of registry lookups gives the same hits, misses
    and size in both packages (names and keys kept): presets and explicit
    spellings share an entry, batched and delta kinds get their own."""
    calls = [
        dict(fn="solve", mode="pd"),
        dict(fn="solve", preset="paper-pd"),
        dict(fn="solve", mode="pd", batched=True),
        dict(fn="solve", mode="pd", batched=True, batch_shards=4),
        dict(fn="solve", preset="pd-chunked"),
        dict(fn="delta", mode="pd"),
        dict(fn="delta", mode="pd", warm=True),
        dict(fn="delta", mode="pd", warm=True, batched=True),
        dict(fn="solve", mode="d"),
        dict(fn="delta", mode="pd", warm=True),
    ]
    for pkg in (japi, tapi):
        pkg.clear_cache()
        for c in calls:
            c = dict(c)
            fn = c.pop("fn")
            (pkg.compiled_solve if fn == "solve" else pkg.compiled_delta)(
                backend="reference", **c)
    j, t = japi.cache_info(), tapi.cache_info()
    assert (t.hits, t.misses, t.currsize) == (j.hits, j.misses, j.currsize)
    assert tapi.KINDS == japi.KINDS
    assert tapi.CACHE_MAXSIZE == japi.CACHE_MAXSIZE
    assert tapi.compiled_solve(mode="pd", backend="reference") is \
        tapi.compiled_solve(preset="paper-pd", backend="reference")
    with pytest.raises(ValueError, match="mode 'd'"):
        tapi.compiled_delta(mode="d", warm=True)
    with pytest.raises(ValueError, match="batched executables only"):
        tapi.compiled_solve(mode="pd", batch_shards=2)


def test_trace_count_eviction_and_clear():
    tapi.clear_cache()
    assert tapi.trace_count() == 0
    cfg = tapi.SolverConfig(**CFG)
    a = tg.grid_instance(5, 5, seed=0, pad_edges=120, device="cpu")
    b = tg.grid_instance(5, 5, seed=1, pad_edges=120, device="cpu")
    c = tg.grid_instance(5, 5, seed=1, pad_edges=160, device="cpu")
    tapi.solve(a, config=cfg, device="cpu")
    tapi.solve(b, config=cfg, device="cpu")         # same shape: no trace
    assert tapi.trace_count() == 1
    tapi.solve(c, config=cfg, device="cpu")         # new shape: one more
    assert tapi.trace_count() == 2
    tapi.solve_batch(tapi.stack_instances([a, b]), config=cfg, device="cpu")
    tapi.solve_batch(tapi.stack_instances([b, a]), config=cfg, device="cpu")
    assert tapi.trace_count() == 3                  # batched: own entry
    info = tapi.cache_info()
    assert (info.misses, info.currsize) == (2, 2)
    tapi.set_cache_maxsize(2)
    assert tapi.trace_count() == 0 and tapi.cache_info().maxsize == 2
    for mode in ("pd", "pd+", "d"):                 # three keys, bound 2
        tapi.solve(a, mode=mode, config=cfg, device="cpu")
    assert tapi.cache_info().currsize == 2
    tapi.solve(a, mode="pd", config=cfg, device="cpu")   # evicted: again
    assert tapi.trace_count() == 4
    tapi.set_cache_maxsize(tapi.CACHE_MAXSIZE)
    tapi.clear_cache()
    assert tapi.trace_count() == 0 and tapi.cache_info().currsize == 0


def test_tree_ready_and_batch_shards(monkeypatch):
    inst = tg.grid_instance(4, 4, seed=0, device="cpu")
    res = tapi.solve(inst, config=tapi.SolverConfig(**CFG), device="cpu")
    assert tapi.tree_ready(res) and tapi.tree_ready((res, None))
    assert tapi.block_until_ready(res) is res
    assert tdist.resolve_batch_shards(None) == 1
    if torch.cuda.device_count() <= 1:
        assert tdist.resolve_batch_shards(4) == 1       # clamped to one
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdist.resolve_batch_shards(4) == 4     # four cards: no clamp
    batch = tapi.stack_instances([inst, inst])
    cfg = tapi.SolverConfig(**CFG)
    got = tapi.solve_batch(batch, config=cfg, batch_shards=2, device="cpu")
    _bitwise(got, tapi.solve_batch(batch, config=cfg, device="cpu"))
    assert tapi.tree_ready(got)
    with pytest.raises(ValueError, match="not divisible"):
        tapi.solve_batch(tapi.stack_instances([inst]), batch_shards=2,
                         device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    inst = tg.grid_instance(4, 4, seed=0, device="cpu")
    batch = tapi.stack_instances([inst])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.solve_batch(batch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.solve_with_state(inst)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.make_patch(16, delete=([0], [1]))
