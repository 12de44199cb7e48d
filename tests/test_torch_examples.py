"""The port's four multicut examples (``repro_torch.examples.quickstart``,
``image_segmentation``, ``serve_tiles``, ``distributed_multicut``) at
``--device cpu``, against the JAX package where it solves the same
instance.

quickstart's four modes and image_segmentation's whole image against
``repro.api.solve`` on the same instance and config: integers exactly,
objective and bound within rtol 1e-5; mode d's bound history within
1e-3 (the reference's compiled message passing fuses multiply-adds; see
``tests/test_torch_modes.py``). Every served tile of serve_tiles bit-equal
to the port's ``api.solve`` of its bucket-padded instance on its route.
distributed_multicut's certificate at world 1, and world 2 over two
spawned gloo ranks giving the same bound and labels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import baselines as jb, graph as jg  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.convert import result_to_numpy  # noqa: E402
from repro_torch.examples import distributed_multicut as dm  # noqa: E402
from repro_torch.examples import image_segmentation as seg  # noqa: E402
from repro_torch.examples import quickstart as qs  # noqa: E402
from repro_torch.examples import serve_tiles as st  # noqa: E402
from repro_torch.serve import pad_instance  # noqa: E402

CPU = ["--device", "cpu"]
RTOL = 1e-5
INTS = ("labels", "rounds", "n_contracted", "n_clusters")
FLOATS = ("objective", "lower_bound", "lb_history")
# as tests/test_torch_modes.py::QUICKSTART_D_LB_RTOL
QUICKSTART_D_LB_RTOL = 1e-3


def _check(t, j, what, d_rtol=None):
    for f in INTS:
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)),
                                      err_msg=f"{what} {f}")
    for f in FLOATS:
        rtol = d_rtol if d_rtol and f != "objective" else RTOL
        np.testing.assert_allclose(getattr(t, f), np.asarray(getattr(j, f)),
                                   rtol=rtol, err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def quickstart():
    return qs.main(CPU)


def test_quickstart_against_reference(quickstart):
    """The four modes of quickstart's instance and config against the
    reference, and GAEC's labels equal to the reference's GAEC."""
    ji = jg.random_instance(seed=0, **qs.INSTANCE)
    jcfg = japi.SolverConfig(max_neg=1024, max_tri_per_edge=8, mp_iters=10)
    for mode in qs.MODES:
        jr = japi.solve(ji, mode=mode, config=jcfg)
        tr = result_to_numpy(quickstart["results"][mode])
        if mode == "d":
            np.testing.assert_allclose(tr.lb_history[0], jr.lb_history[0],
                                       rtol=RTOL)
        _check(tr, jr, mode, QUICKSTART_D_LB_RTOL if mode == "d" else None)
    np.testing.assert_array_equal(quickstart["gaec_labels"], jb.gaec(ji))
    assert len(quickstart["served"]) == 4 \
        and quickstart["engine"].n_completed == 4


def test_image_segmentation_against_reference():
    """The whole image (576 nodes, the sparse path) against the
    reference's PD solve, and GAEC's labels equal to the reference's
    GAEC."""
    out = seg.main(CPU)
    ji = jg.grid_instance(seg.H, seg.W, seed=3, n_segments=5)
    jcfg = japi.SolverConfig(max_neg=4096, max_tri_per_edge=8, nbr_k=8,
                             mp_iters=10, contract_frac=0.5, max_rounds=40)
    jr = japi.solve(ji, mode="pd", config=jcfg)
    _check(result_to_numpy(out["result"]), jr, "whole image")
    np.testing.assert_array_equal(out["gaec_labels"], jb.gaec(ji))
    assert len(out["tile_results"]) == 4


def test_serve_tiles_bit_equal_to_padded_solves():
    """Every tile's result equals ``api.solve`` of its bucket-padded
    instance on its route bit for bit; the stream made no first call
    past the warm-up, and the warm-up stayed within its bound."""
    out = st.main(CPU)
    assert len(out["results"]) == 12
    assert out["first_calls"] <= out["first_call_bound"]
    for t, res in zip(out["tickets"], out["results"]):
        r = t.route
        want = tapi.solve(pad_instance(t.inst, t.bucket), mode=r.mode,
                          config=r.config, backend=r.backend, device="cpu")
        n = t.inst.num_nodes
        got, ref = result_to_numpy(res), result_to_numpy(want)
        np.testing.assert_array_equal(got.labels[:n], ref.labels[:n])
        for f in got._fields:
            if f != "labels":
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(ref, f), err_msg=f)


@pytest.fixture(scope="module")
def distributed_one():
    return dm.main(CPU)


def test_distributed_multicut_certificate(distributed_one):
    out = distributed_one
    assert out["world"] == 1 and np.isfinite(out["lower_bound"])
    assert out["lower_bound"] <= out["objective"] + 1e-3
    assert out["lower_bound"] <= out["single_device_objective"] + 1e-3
    assert out["labels"].shape == (dm.N_NODES,)
    assert 0 < out["quotient_nodes"] < dm.N_NODES


def test_distributed_multicut_two_ranks(distributed_one):
    """World 2 over two spawned gloo ranks (4 blocks each): the same
    bound, mapping and composed labels as world 1."""
    two = dm.main(CPU + ["--world", "2"])
    assert two["lower_bound"] == distributed_one["lower_bound"]
    np.testing.assert_array_equal(two["mapping"], distributed_one["mapping"])
    np.testing.assert_array_equal(two["labels"], distributed_one["labels"])
    assert two["objective"] == distributed_one["objective"]
