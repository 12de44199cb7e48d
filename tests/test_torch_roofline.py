"""The port's roofline accounting (``repro_torch.roofline``) and the RAMA
arch config (``repro_torch.configs.rama_multicut``), after
``tests/test_roofline.py``.

``profile_solve_round`` on both data paths with the reference test's
structural asserts; the dispatch-mode counter on ops of known size; the
hand kernels' ``work()`` counted once and only through ``work()``; the
analysis helpers on the H100 entry; and the arch cells' step functions at
small dims against the JAX package's (integers exact, floats rtol 1e-5).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

from torch.utils._python_dispatch import _disable_current_modes  # noqa: E402,E501

from repro.configs import rama_multicut as jrama  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import solver as jsolver  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs import rama_multicut as trama  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.convert import instance_from_numpy  # noqa: E402
from repro_torch.core.graph import random_instance  # noqa: E402
from repro_torch.core.solver import SolverConfig  # noqa: E402
from repro_torch.kernels.cycle_intersect import ops as isect_ops  # noqa: E402,E501
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref  # noqa: E402,E501
from repro_torch.kernels.triangle_mp import ops as mp_ops  # noqa: E402
from repro_torch.kernels.triangle_mp.ref import mp_phase_ref  # noqa: E402
from repro_torch.roofline import (  # noqa: E402
    FP32_FLOPS, HW, PHASES, TF32_FLOPS, WorkCounter, count_work,
    dominant_term, loop_corrected, profile_solve_round, roofline_fraction,
    roofline_terms, step_time_estimate,
)

RTOL = 1e-5


def _inst():
    return random_instance(40, 0.2, seed=0, pad_edges=256, pad_nodes=64,
                           device="cpu")


@pytest.mark.parametrize("impl", ["dense", "sparse"])
def test_profile_solve_round(impl):
    """One round profiled end to end on both data paths: every phase gets
    counted flops/bytes and a wall, MP carries the loop-trip correction
    (checked inside against the direct count), and the round totals are
    the phase sums."""
    cfg = SolverConfig(max_neg=64, max_tri_per_edge=4, nbr_k=4, mp_iters=3,
                       graph_impl=impl)
    prof = profile_solve_round(_inst(), cfg)
    assert prof["impl"] == impl and prof["hw"] == HW.name
    assert prof["device"] == "cpu" and prof["timer"] == "host_clock"
    assert set(prof["phases"]) == set(PHASES)
    for rec in prof["phases"].values():
        assert rec["wall_s"] > 0
        assert rec["flops"] >= 0 and rec["bytes_accessed"] > 0
        assert rec["collective_bytes"] == 0
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert rec["kernel_flops"] == rec["kernel_bytes"] == 0   # CPU
    loop = prof["phases"]["message_passing"]["loop"]
    assert loop["iters"] == cfg.mp_iters
    assert loop["flops_depth2"] > loop["flops_depth1"]
    mp = prof["phases"]["message_passing"]
    assert mp["flops"] == loop_corrected(loop["flops_depth1"],
                                         loop["flops_depth2"], cfg.mp_iters)
    assert prof["round_wall_s"] == pytest.approx(
        sum(p["wall_s"] for p in prof["phases"].values()))
    assert prof["round_roofline_s"] == pytest.approx(
        sum(p["roofline_s"] for p in prof["phases"].values()))


def test_profile_solve_round_sharded_raises():
    """The sharded round's profile at S = 1 in process (no process group):
    the reference's phases, record keys and top-level keys (all but
    ``peak_temp_bytes``, which XLA's memory analysis gives and eager torch
    does not); job = per-device = this rank's counts; no collective
    bytes; the MP loop correction. It raises where the sharded solve
    does: the dense path is refused with the solve's message."""
    cfg = SolverConfig(state_shards=1, graph_impl="sparse",
                       first_round_cycles45=False, max_neg=64, mp_iters=3)
    prof = profile_solve_round(_inst(), cfg)
    ref_rec = jsolver._sharded_phase_record(
        dict(flops=1, bytes_accessed=1, collective_bytes=0,
             peak_temp_bytes=0), 1.0, janalysis.HW, 1)
    assert prof["state_shards"] == 1 and prof["rank"] == 0
    assert {"impl", "hw", "mp_iters", "state_shards", "phases",
            "round_wall_s", "round_roofline_s"} <= set(prof)
    assert tuple(prof["phases"]) == PHASES
    for name, rec in prof["phases"].items():
        assert set(ref_rec) - {"peak_temp_bytes"} <= set(rec), name
        assert rec["same_on_every_rank"] and rec["wall_s"] > 0
        for k in ("flops", "bytes_accessed", "collective_bytes",
                  "torch_ops", "kernel_flops", "kernel_bytes"):
            assert rec[k] == rec[f"{k}_per_device"] == rec[f"rank_{k}"]
        assert rec["collective_bytes"] == rec["collective_calls"] == 0
        assert rec["bytes_accessed"] > 0 and rec["flops"] > 0
        assert rec["roofline_s"] == step_time_estimate(rec["terms"])
    mp = prof["phases"]["message_passing"]
    loop = mp["loop"]
    assert loop["iters"] == 3 and loop["flops_depth2"] > loop["flops_depth1"]
    assert mp["flops"] == loop_corrected(loop["flops_depth1"],
                                         loop["flops_depth2"], 3)
    assert prof["round_wall_s"] == pytest.approx(
        sum(p["wall_s"] for p in prof["phases"].values()))
    with pytest.raises(ValueError, match="CSR data path only"):
        profile_solve_round(_inst(), dataclasses.replace(
            cfg, graph_impl="dense"))


def test_work_counter_on_known_ops():
    """Reads once, writes once; views, allocations and a copy onto itself
    move nothing; an in-place op reads and writes its first input once;
    an in-place scatter touches only what it updates (an accumulating
    one reads each updated element too), a gather reads only
    what it returns; arithmetic counts
    one flop an output element, a reduction one an input element, a
    scatter one a source element, a matmul 2·m·n·k."""
    n = 1000
    a = torch.ones(n)
    b = torch.ones(n)
    with WorkCounter() as wc:
        c = a + b
    assert (wc.flops, wc.bytes, wc.ops) == (n, 12 * n, 1)
    with WorkCounter() as wc:
        a.view(10, 100)
        a[3:7]
        torch.empty(n)
        a.copy_(a)
    assert (wc.flops, wc.bytes, wc.ops) == (0, 0, 0)
    with WorkCounter() as wc:
        a.add_(b)
    assert (wc.flops, wc.bytes) == (n, 12 * n)
    with WorkCounter() as wc:
        c.sum()
    assert (wc.flops, wc.bytes) == (n, 4 * n + 4)
    with WorkCounter() as wc:
        torch.sort(c)
    assert wc.flops == 0 and wc.bytes == 4 * n + 4 * n + 8 * n
    big = torch.zeros(100, 100)
    idx, vals = torch.tensor([3, 7, 11]), torch.ones(3)
    with WorkCounter() as wc:
        big.index_put_((idx, idx), vals)        # 3 elements set
    assert wc.bytes == 8 * 3 + 4 * 3 + 4 * 3 and wc.flops == 0
    with WorkCounter() as wc:                   # 3 read-modify-writes
        big.index_put_((idx, idx), vals, accumulate=True)
    assert wc.bytes == 8 * 3 + 4 * 3 + 2 * 4 * 3 and wc.flops == 3
    with WorkCounter() as wc:
        big.index_put_((idx, idx), vals, True)
    assert wc.bytes == 8 * 3 + 4 * 3 + 2 * 4 * 3 and wc.flops == 3
    with WorkCounter() as wc:
        big.index_fill_(0, idx, 2.0)            # 3 rows of 100
    assert wc.bytes == 8 * 3 + 4 * 300
    with WorkCounter() as wc:
        big.view(-1).scatter_add_(0, idx, vals)  # 3 read-modify-writes
    assert wc.bytes == 8 * 3 + 4 * 3 + 2 * 4 * 3 and wc.flops == 3
    with WorkCounter() as wc:
        big[idx]                                # 3 rows of 100 gathered
    assert wc.bytes == 8 * 3 + 2 * 4 * 300 and wc.flops == 0
    with WorkCounter() as wc:
        big.index_select(1, idx)
    assert wc.bytes == 8 * 3 + 2 * 4 * 300
    x, y = torch.ones(8, 16), torch.ones(16, 4)
    with WorkCounter() as wc:
        x @ y
    assert wc.flops == 2 * 8 * 16 * 4
    assert wc.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)


def _mp_inputs(seed=0, T=64, E=200, iters=3):
    rng = np.random.default_rng(seed)
    tri = torch.from_numpy(rng.integers(0, E, (T, 3)).astype(np.int32))
    valid = torch.from_numpy(rng.random(T) < 0.7)
    tri = torch.where(valid[:, None], tri, torch.zeros_like(tri))
    cost = torch.from_numpy(rng.normal(size=E).astype(np.float32))
    ev = torch.from_numpy(rng.random(E) < 0.9)
    return cost, ev, tri, valid, iters


def test_kernel_work_is_counted_once(monkeypatch):
    """Through the wrapper on the CPU (its plain version behind it) the
    count equals the plain version's own count and adds no kernel work;
    with a stand-in kernel behind the wrapper (the plain version run out
    of the counter's sight, one launch counted as the kernel counts it)
    the count is exactly the kernel's ``work()``: nothing of the kernel
    is counted twice and nothing through an aten op."""
    args = _mp_inputs()
    cost, ev, tri, valid, iters = args
    plain, want = count_work(mp_ops.mp_phase, *args, mp_inputs=args)
    alone, _ = count_work(mp_phase_ref, *args)
    assert (plain["flops"], plain["bytes_accessed"]) == \
        (alone["flops"], alone["bytes_accessed"])
    assert plain["kernel_launches"]["triangle_mp"] == 0
    assert plain["kernel_flops"] == 0

    def fake_phase(*a):
        with _disable_current_modes():
            out = mp_phase_ref(*a)
        mp_ops.launches += 1
        return out
    monkeypatch.setattr(mp_ops, "mp_phase_ref", fake_phase)
    kern, got = count_work(mp_ops.mp_phase, *args, mp_inputs=args)
    assert kern["torch_ops"] == 0
    assert kern["kernel_launches"]["triangle_mp"] == 1
    assert (kern["flops"], kern["bytes_accessed"]) == \
        mp_ops.work(cost, tri, valid, iters)
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    rng = np.random.default_rng(1)
    ci = torch.from_numpy(np.sort(rng.integers(0, 50, (32, 16)), 1)
                          .astype(np.int32))
    cj = torch.from_numpy(np.sort(rng.integers(0, 50, (32, 24)), 1)
                          .astype(np.int32))

    def fake_rows(a, b):
        with _disable_current_modes():
            out = intersect_rows_ref(a, b)
        isect_ops.launches += 1
        return out
    monkeypatch.setattr(isect_ops, "intersect_rows_ref", fake_rows)
    kern, _ = count_work(isect_ops.intersect_rows, ci, cj)
    assert kern["torch_ops"] == 0
    assert (kern["flops"], kern["bytes_accessed"]) == \
        isect_ops.work(32, 16, 24)
    with pytest.raises(ValueError, match="inputs"):
        count_work(mp_ops.mp_phase, *args)      # no inputs for its work


def test_kernel_work_of_known_shapes():
    assert isect_ops.work(32, 128, 128) == (2 * 32 * 128 * 8,
                                            4 * (2 * 32 * 128 + 32 * 128))
    assert isect_ops.work(8, 1, 1) == (2 * 8 * 1 * 1, 4 * (2 * 8 + 8))
    assert mp_ops.sweep_work(1000) == (mp_ops.SWEEP_FLOPS * 1000, 24_000)
    # three valid triangles on edges {0,1,2}, {0,1,3}, {4,5,6}, one invalid
    tri = torch.tensor([[0, 1, 2], [0, 1, 3], [4, 5, 6], [0, 0, 0]],
                       dtype=torch.int32)
    valid = torch.tensor([True, True, True, False])
    cost = torch.zeros(10)
    ops, nbytes = mp_ops.work(cost, tri, valid, 2)
    # 7 distinct edges, segment lengths 2, 2, 1, 1, 1, 1, 1 (Σ = 9, Σ² = 13)
    assert nbytes == 4 + 12 * 3 + 3 * 3 * 12 + 4 * 7 + 12 * 3 + 4 * 7
    assert ops == 2 * (13 + 9 * 3 + mp_ops.SWEEP_FLOPS * 3) + 9 + 7


def test_analysis_helpers_on_the_h100():
    assert HW.name == "NVIDIA H100 80GB HBM3"
    assert (HW.peak_flops, HW.hbm_bw, HW.hbm_bytes) == (989e12, 3.35e12,
                                                        80e9)
    assert (FP32_FLOPS, TF32_FLOPS) == (67e12, 495e12)  # the other pipes
    assert set(dataclasses.asdict(HW)) == set(
        dataclasses.asdict(janalysis.HW))          # the reference's fields
    terms = roofline_terms(flops=HW.peak_flops, bytes_accessed=HW.hbm_bw,
                           coll_bytes=HW.ici_bw)
    for k in ("compute_s", "memory_s", "collective_s"):
        assert terms[k] == pytest.approx(1.0)
    for t in ({"compute_s": 3, "memory_s": 1, "collective_s": 2},
              {"compute_s": 0, "memory_s": 1, "collective_s": 2}):
        assert dominant_term(t) == janalysis.dominant_term(t)
    t = {"compute_s": 3.0, "memory_s": 1.0, "collective_s": 2.0}
    assert step_time_estimate(t) == 3.0
    assert step_time_estimate(t, overlap=False) == 6.0
    terms = {"compute_s": 1.0, "memory_s": 0.5, "collective_s": 0.1}
    assert roofline_fraction(HW.peak_flops, terms) == pytest.approx(1.0)
    assert roofline_fraction(HW.peak_flops * 0.5, terms) == \
        pytest.approx(0.5)
    assert loop_corrected(15.0, 20.0, 8) == pytest.approx(50.0)


# ---------------------------------------------------------------------------
# The rama-multicut arch config
# ---------------------------------------------------------------------------

SMALL = {"solver": ShapeCell("pd_round_sm", "solver",
                             dict(n_nodes=64, n_edges=320)),
         "mp": ShapeCell("mp_sweep_1m", "mp",
                         dict(n_edges=300, n_triangles=128))}


def test_rama_arch_registry_and_cells():
    arch = get_arch("rama-multicut")
    assert arch is trama.ARCH
    assert set(arch.shapes) == set(jrama.RAMA_SHAPES)
    for name, cell in jrama.RAMA_SHAPES.items():
        assert arch.shapes[name].dims == cell.dims
        assert arch.shapes[name].kind == cell.kind
        assert arch.model_flops(arch.shapes[name]) == \
            jrama.ARCH.model_flops(cell)
    for name in ("pd_round_sm", "pd_round_lg", "mp_sweep_1m"):
        ins = arch.abstract_inputs(arch.shapes[name])
        want = jrama.ARCH.abstract_inputs(jrama.RAMA_SHAPES[name])
        assert set(ins) == set(want)
        for k, t in ins.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
    # dist_pd: the reference's dist_inputs on a one-device mesh (one
    # block per rank; one rank without a process group) and its round
    import jax
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    ins = arch.abstract_inputs(arch.shapes["dist_pd"])
    want = jrama.ARCH.dist_inputs(mesh, jrama.RAMA_SHAPES["dist_pd"])
    assert set(ins) == set(want)
    for k, t in ins.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
    assert callable(arch.step_fn(arch.shapes["dist_pd"]))


def test_rama_pd_round_step_matches_reference():
    """The pd_round step at small dims: the contracted instance, the
    mapping exactly; its costs and the bound within rtol 1e-5."""
    cell = SMALL["solver"]
    ji = jg.grid_instance(8, 8, seed=2, pad_edges=cell.dims["n_edges"])
    jout = jrama.ARCH.step_fn(jrama.ShapeCell(cell.name, cell.kind,
                                              cell.dims))(*ji)
    tout = trama.ARCH.step_fn(cell)(*instance_from_numpy(
        *[np.asarray(x) for x in ji], device="cpu"))
    names = ("u", "v", "cost", "edge_valid", "node_valid", "mapping", "lb")
    for name, t, j in zip(names, tout, jout):
        if name in ("cost", "lb"):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                       atol=RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)


def test_rama_mp_step_matches_reference():
    cell = SMALL["mp"]
    E, T = cell.dims["n_edges"], cell.dims["n_triangles"]
    cost, ev, tri, valid, _ = _mp_inputs(seed=3, T=T, E=E)
    jout = jrama.ARCH.step_fn(jrama.ShapeCell(cell.name, cell.kind,
                                              cell.dims))(
        cost.numpy(), ev.numpy(), tri.numpy(), valid.numpy())
    tout = trama.ARCH.step_fn(cell)(cost, ev, tri, valid)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=RTOL)
