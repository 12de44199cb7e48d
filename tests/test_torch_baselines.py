"""The port's sequential baselines (``repro_torch.core.baselines``: GAEC,
BEC, GEF, ICP, greedy-join local search, brute force) against the JAX
package's on the same instances: labels, bounds and objectives exactly
equal (host code on the same int32/float32 arrays, same heaps, same tie
order). Instances: ``tests/conftest.py``'s tiny ones and one 24×24 grid."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

from repro.core import baselines as jb  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch.convert import instance_from_numpy  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

HEURISTICS = ("gaec", "bec", "gef")


def _port(ji):
    return instance_from_numpy(*[np.asarray(x) for x in ji], device="cpu")


@pytest.fixture(scope="module")
def grid():
    return jg.grid_instance(24, 24, seed=0)


def _same_on(ji):
    ti = _port(ji)
    for name in HEURISTICS:
        want = getattr(jb, name)(ji)
        got = getattr(tb, name)(ti)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert tb.objective(ti, got) == jb.objective(ji, want)
        ls_t = tb.greedy_join_local_search(ti, got)
        np.testing.assert_array_equal(
            ls_t, jb.greedy_join_local_search(ji, want), err_msg=name)
    assert tb.icp(ti) == jb.icp(ji)
    return ti


def test_baselines_equal_reference_on_tiny(tiny_instances):
    ti = _same_on(tiny_instances)
    opt_t, lab_t = tb.brute_force(ti)
    opt_j, lab_j = jb.brute_force(tiny_instances)
    assert opt_t == opt_j
    np.testing.assert_array_equal(lab_t, lab_j)
    for name in HEURISTICS:
        assert tb.objective(ti, getattr(tb, name)(ti)) >= opt_t - 1e-6
    assert tb.icp(ti) <= opt_t + 1e-6


def test_baselines_equal_reference_on_triangle(triangle_instance,
                                               tiny_instance):
    for ji in (triangle_instance, tiny_instance):
        ti = _same_on(ji)
        opt_t, lab_t = tb.brute_force(ti)
        opt_j, lab_j = jb.brute_force(ji)
        assert opt_t == opt_j
        np.testing.assert_array_equal(lab_t, lab_j)


def test_baselines_equal_reference_on_grid(grid):
    """A 24×24 grid (576 nodes, long-range edges): every heuristic's
    labels, the local search after each and ICP's bound, exactly."""
    ti = _same_on(grid)
    assert len(np.unique(tb.gaec(ti))) > 1


def test_baselines_read_the_instance_through_to_host_edges():
    """The port's instance generator gives the same host edges as the
    reference's, so the baselines run on equal arrays either way."""
    ti = tg.grid_instance(24, 24, seed=0, device="cpu")
    for a, b in zip(tg.to_host_edges(ti), jg.to_host_edges(
            jg.grid_instance(24, 24, seed=0))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
