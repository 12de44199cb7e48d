"""Sharding over cards in one process: separation sharding
(``separation_shards``, the ``pd-sharded`` preset) and batch sharding
(``solve_batch(batch_shards=...)``, batched ``compiled_solve`` and the
serving engine's routes), against one shard and the JAX package.

There is no card here: ``torch.cuda.device_count`` is patched to 4, so the
shard counts resolve above 1 and :func:`repro_torch.core.dist.
shard_devices` gives the CPU once per shard; the split, the per-shard
copies and the gather run as on cards. Everything is bit-identical to one
shard by construction (integers are gathered, no float is summed across
shards), so every comparison between shard counts is exact. Against the
JAX package's ``pd-sharded`` solve on one CPU device (its S clamps to 1;
its own tests pin its S = 4 equal to its S = 1): labels exactly,
objective and bound within rtol 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import instance_from_numpy  # noqa: E402
from repro_torch.core import dist as tdist  # noqa: E402
from repro_torch.core.cycles import separate  # noqa: E402
from repro_torch.core.graph import random_instance  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BucketPolicy, Route, SolveEngine, pad_instance,
)

CPU = "cpu"
RTOL = 1e-5
FIELDS = ("labels", "objective", "lower_bound", "rounds", "lb_history",
          "n_contracted", "n_clusters")
BATCH_CFG = dict(max_neg=32, mp_iters=2, max_rounds=4)


def _jinst():
    return jg.random_instance(60, 0.15, seed=3, pad_edges=1024,
                              pad_nodes=64)


def _inst():
    return instance_from_numpy(*[np.asarray(x) for x in _jinst()],
                               device=CPU)


@pytest.fixture
def four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def _bitwise(a, b, what=""):
    for f, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f"{what} {f}"
        else:
            _bitwise(x, y, f"{what} {f}")


def test_resolve_and_shard_devices(four_cards, monkeypatch):
    """Both counts clamp to the cards present; the device map gives the
    CPU S times for a CPU instance, ``cuda:0 .. cuda:S-1`` for a CUDA one,
    the instance's own device for one shard, and raises when a shard's
    card is missing."""
    for fn in (tdist.resolve_separation_shards, tdist.resolve_batch_shards):
        assert fn(None) == fn(0) == fn(1) == 1
        assert fn(2) == 2 and fn(4) == fn(64) == 4
    assert tdist.shard_devices(3, CPU) == [torch.device(CPU)] * 3
    assert tdist.shard_devices(1, "cuda:1") == [torch.device("cuda", 1)]
    assert tdist.shard_devices(4, "cuda") == [torch.device("cuda", r)
                                              for r in range(4)]
    with pytest.raises(ValueError, match="5 shards need 5 CUDA devices"):
        tdist.shard_devices(5, "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert tdist.resolve_separation_shards(4) == 1


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("chunk", [0, 64])
@pytest.mark.parametrize("short", [0, 4])
def test_separation_shards_bit_identical(S, chunk, short, four_cards):
    """One sparse separation round with 4/5-cycles at S shards against
    S = 1: triangles, the chorded instance (chord slots included) and the
    spliced CSR bit for bit. ``short`` = 4 lies below the largest
    attractive degree, so the long bucket runs (ungated at S > 1)."""
    inst = _inst()
    pos = inst.edge_valid & (inst.cost > 0)
    deg = torch.bincount(torch.cat([inst.u[pos], inst.v[pos]]).long())
    assert int(deg.max()) > 4
    kw = dict(max_neg=64, max_tri_per_edge=4, graph_impl="sparse",
              sparse_row_cap=32, sparse_row_cap_short=short,
              separation_chunk=chunk, update_csr=True)
    one = separate(inst, separation_shards=1, **kw)
    got = separate(inst, separation_shards=S, **kw)
    _bitwise(got.triangles, one.triangles, "triangles")
    _bitwise(got.instance, one.instance, "instance")
    _bitwise(got.csr, one.csr, "csr")
    assert bool(one.triangles.valid.any())
    assert int(one.instance.edge_valid.sum()) > int(inst.edge_valid.sum())


@pytest.fixture(scope="module")
def jax_pd_sharded():
    r = japi.solve(_jinst(), preset="pd-sharded")
    return {f: np.asarray(getattr(r, f)) for f in FIELDS}


@pytest.mark.parametrize("S", [2, 4])
def test_pd_sharded_solve(S, four_cards, jax_pd_sharded):
    """The whole ``pd-sharded`` solve at S shards is the S = 1 solve
    (``pd-chunked``, the same config without shards) bit for bit; its
    labels equal the JAX package's ``pd-sharded`` labels exactly, its
    objective and bound within rtol 1e-5. The preset is the reference's,
    and its count is clamped before the registry key is formed."""
    p, jp = api.get_preset("pd-sharded"), japi.get_preset("pd-sharded")
    assert (p.mode, p.config.cache_key()) == \
        (jp.mode, jp.config.cache_key())
    inst = _inst()
    cfg = dataclasses.replace(p.config, separation_shards=S)
    got = api.solve(inst, config=cfg, device=CPU)
    one = api.solve(inst, preset="pd-chunked", device=CPU)
    _bitwise(got, one)
    if S == 4:
        _bitwise(api.solve(inst, preset="pd-sharded", device=CPU), one)
        assert api.compiled_solve(preset="pd-sharded") is \
            api.compiled_solve(config=cfg)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  jax_pd_sharded["labels"])
    for k in ("rounds", "n_contracted", "n_clusters"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      jax_pd_sharded[k], err_msg=k)
    for k in ("objective", "lower_bound"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   jax_pd_sharded[k], rtol=RTOL, err_msg=k)


def _batch_insts(n=4):
    return [random_instance(12, 0.5, seed=s, pad_edges=96, pad_nodes=16,
                            device=CPU) for s in range(n)]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_solve_batch_shards_bit_identical(S, impl, four_cards):
    """``solve_batch(batch_shards=S)`` equals the unsharded batch and each
    slot's own ``solve``, bit for bit, on both data paths."""
    cfg = api.SolverConfig(graph_impl=impl, **BATCH_CFG)
    insts = _batch_insts()
    batch = api.stack_instances(insts)
    base = api.solve_batch(batch, config=cfg, device=CPU)
    got = api.solve_batch(batch, config=cfg, batch_shards=S, device=CPU)
    _bitwise(got, base)
    for inst, r in zip(insts, api.unstack_results(got)):
        _bitwise(r, api.solve(inst, config=cfg, device=CPU))
    fn = api.compiled_solve(config=cfg, batched=True, batch_shards=S)
    assert fn is api._compiled("pd", cfg, "cuda", True, S, "solve", False,
                               0)
    assert api.tree_ready(got)


def test_batch_shards_guards(four_cards):
    """The reference's refusals: an indivisible batch, ``batch_shards``
    on a single solve or a delta batch, and ``batch_shards`` together
    with ``separation_shards``."""
    cfg = api.SolverConfig(**BATCH_CFG)
    with pytest.raises(ValueError, match="not divisible"):
        api.solve_batch(api.stack_instances(_batch_insts(3)), config=cfg,
                        batch_shards=2, device=CPU)
    with pytest.raises(ValueError, match="batched executables only"):
        api.compiled_solve(config=cfg, batched=False, batch_shards=2)
    with pytest.raises(ValueError, match="kind='solve'"):
        api._compiled("pd", cfg, "cuda", True, 2, "delta")
    with pytest.raises(ValueError, match="mutually exclusive"):
        api.solve_batch(api.stack_instances(_batch_insts(2)),
                        preset="pd-sharded", batch_shards=2, device=CPU)
    with pytest.raises(ValueError, match="cannot both shard"):
        Route(config=api.get_preset("pd-sharded").config, batch_shards=2)


def test_engine_batch_sharded_route(four_cards):
    """An engine route with ``batch_shards=2`` dispatches through the
    sharded entry; every result equals ``api.solve`` of its bucket-padded
    instance, and the ladder's rungs split evenly over the shards."""
    cfg = api.SolverConfig(**BATCH_CFG)
    route = Route(mode="pd", config=cfg, batch_shards=2)
    eng = SolveEngine(policy=BucketPolicy(node_floor=16, edge_floor=128),
                      batch_cap=4, flush_timeout_s=None, device=CPU)
    insts = _batch_insts(8)
    tickets = [eng.submit(i, route=route) for i in insts]
    eng.flush()
    assert eng.stats.n_completed == 8
    assert all(r % 2 == 0 for r in eng._ladder(route))
    for inst, t in zip(insts, tickets):
        res = t.result()
        bucket = eng.policy.bucket_of(inst)
        direct = api.solve(pad_instance(inst, bucket), config=cfg,
                           device=CPU)
        assert torch.equal(res.objective, direct.objective)
        assert torch.equal(res.labels, direct.labels[:inst.num_nodes])
