"""The solver modes p, pd, pd+ and d of the port on both separation data
paths, against the JAX package on the same numpy-made inputs.

``tests/test_graph_impl.py``'s three instance families at its one padded
shape (32 nodes, 512 edge slots), so each reference solve compiles once
per (mode, data path); plus ``examples/quickstart.py``'s instance. Integer
outputs (labels, rounds, per-round contraction and cluster counts) must be
exactly equal; the objective, lower bound and lower-bound history are
float sums that torch and XLA reduce in different orders: rtol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.convert import instance_from_numpy, result_to_numpy  # noqa: E402,E501

RTOL = 1e-5
PAD_N, PAD_E = 32, 512
FAMILIES = {
    "random": lambda s: jg.random_instance(24, 0.3, seed=s, pad_edges=PAD_E,
                                           pad_nodes=PAD_N),
    "grid": lambda s: jg.grid_instance(5, 6, seed=s, pad_edges=PAD_E,
                                       pad_nodes=PAD_N),
    "cluster": lambda s: jg.cluster_instance(24, seed=s, pad_edges=PAD_E,
                                             pad_nodes=PAD_N),
}
MODES = ("p", "pd", "pd+", "d")


def _pair(ji):
    return instance_from_numpy(*[np.asarray(x) for x in ji], device="cpu")


def _check(t, j, what):
    for f in ("labels", "rounds", "n_contracted", "n_clusters"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)),
                                      err_msg=f"{what} {f}")
    for f in ("objective", "lower_bound", "lb_history"):
        np.testing.assert_allclose(getattr(t, f), np.asarray(getattr(j, f)),
                                   rtol=RTOL, err_msg=f"{what} {f}")


# ---------------------------------------------------------------------------
# Solves: every mode on both data paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dense", "sparse"])
@pytest.mark.parametrize("mode", MODES)
def test_solve_mode_matches_reference(mode, impl):
    for family in sorted(FAMILIES):
        ji = FAMILIES[family](0)
        jr = japi.solve(ji, mode=mode, graph_impl=impl)
        tr = result_to_numpy(tapi.solve(_pair(ji), mode=mode,
                                        graph_impl=impl, device="cpu"))
        _check(tr, jr, f"{mode} {impl} {family}")
        assert int(tr.rounds) >= 1
        if mode == "d":
            assert np.isinf(tr.objective) and tr.objective > 0
            np.testing.assert_array_equal(tr.labels, np.arange(PAD_N))
            assert np.all(np.diff(tr.lb_history) >= -1e-5)
        elif mode == "p":
            assert np.isneginf(tr.lower_bound)
        else:
            assert float(tr.lower_bound) <= float(tr.objective) + 1e-4


@pytest.mark.parametrize("mode", MODES)
def test_dense_equals_sparse_in_the_port(mode):
    """The port's dense solve equals its sparse solve, as
    ``tests/test_graph_impl.py`` pins for the reference: labels and
    integer histories exactly, objective and LB within 1e-4; and ``auto``
    picks dense at 32 padded nodes."""
    for family in sorted(FAMILIES):
        ti = _pair(FAMILIES[family](1))
        rd = result_to_numpy(tapi.solve(ti, mode=mode, graph_impl="dense",
                                        device="cpu"))
        rs = result_to_numpy(tapi.solve(ti, mode=mode, graph_impl="sparse",
                                        device="cpu"))
        ra = result_to_numpy(tapi.solve(ti, mode=mode, device="cpu"))
        for f in ("labels", "rounds", "n_contracted", "n_clusters"):
            np.testing.assert_array_equal(rd._asdict()[f], rs._asdict()[f],
                                          err_msg=f"{family} {f}")
        for f in ("objective", "lower_bound"):
            np.testing.assert_allclose(rd._asdict()[f], rs._asdict()[f],
                                       atol=1e-4, err_msg=f"{family} {f}")
        for f, g in zip(rd, ra):
            np.testing.assert_array_equal(f, g)


# the reference's compiled message passing contracts multiply-adds (XLA
# fusion), the port computes each product and sum on its own, as the
# reference's own op-by-op arithmetic does (pinned below by
# test_reference_mp_rounding_compiled_vs_op_by_op): reparametrised costs
# differ by float32 ulps. Over quickstart's 4 dual rounds (max_neg 1024 of
# 4096 slots) such ulps reorder near-tied repulsive edges, so mode d's
# later rounds separate other triangles: its final LB differs from the
# compiled reference's by ~2.5e-4 relative, with labels and integer
# histories equal.
QUICKSTART_D_LB_RTOL = 1e-3


def test_quickstart_instance_all_modes():
    """``examples/quickstart.py``'s instance (200 nodes padded to 256: the
    dense path under ``auto``) and config, in all four modes. Integers
    exact; objective and round-0 LB within 1e-5; mode d's later rounds
    within QUICKSTART_D_LB_RTOL (see the note above it)."""
    ji = jg.random_instance(n=200, p=0.08, seed=0, pad_edges=4096,
                            pad_nodes=256)
    ti = _pair(ji)
    jcfg = japi.SolverConfig(max_neg=1024, max_tri_per_edge=8, mp_iters=10)
    tcfg = tapi.SolverConfig(max_neg=1024, max_tri_per_edge=8, mp_iters=10)
    for mode in MODES:
        jr = japi.solve(ji, mode=mode, config=jcfg)
        tr = result_to_numpy(tapi.solve(ti, mode=mode, config=tcfg,
                                        device="cpu"))
        if mode != "d":
            _check(tr, jr, mode)
            continue
        for f in ("labels", "rounds", "n_contracted", "n_clusters"):
            np.testing.assert_array_equal(getattr(tr, f),
                                          np.asarray(getattr(jr, f)))
        np.testing.assert_allclose(tr.lb_history[0], jr.lb_history[0],
                                   rtol=RTOL)
        np.testing.assert_allclose(tr.lb_history, np.asarray(jr.lb_history),
                                   rtol=QUICKSTART_D_LB_RTOL)


def test_reference_mp_rounding_compiled_vs_op_by_op():
    """On quickstart's round-0 triangles, 10 MP iterations: the port gives
    the bits of the reference run op by op, and stays within 1e-6 of the
    reference's compiled (jitted) run, which fuses multiply-adds."""
    import jax.numpy as jnp
    from repro.core import cycles as jcy
    from repro.core import message_passing as jmp
    from repro_torch.core import cycles as tcy
    from repro_torch.core import message_passing as tmp
    ti = _pair(jg.random_instance(n=200, p=0.08, seed=0, pad_edges=4096,
                                  pad_nodes=256))
    ts = tcy.separate(ti, max_neg=1024, max_tri_per_edge=8,
                      with_cycles45=True, graph_impl="dense")
    cost = jnp.asarray(ts.instance.cost.numpy())
    valid = jnp.asarray(ts.instance.edge_valid.numpy())
    state = jmp.init_mp(jcy.Triangles(
        edges=jnp.asarray(ts.triangles.edges.numpy()),
        valid=jnp.asarray(ts.triangles.valid.numpy())))
    _, port, _ = tmp.run_message_passing(ts.instance.cost,
                                         ts.instance.edge_valid,
                                         tmp.init_mp(ts.triangles), 10)
    st = state
    for _ in range(10):
        st = jmp.triangles_to_edges(jmp.edges_to_triangles(st, cost))
    op_by_op = jmp.reparametrized_costs(cost, st)
    _, compiled, _ = jmp.run_message_passing(cost, valid, state, 10)
    np.testing.assert_array_equal(port.numpy(), np.asarray(op_by_op))
    np.testing.assert_allclose(np.asarray(compiled), port.numpy(), rtol=0,
                               atol=1e-6)
