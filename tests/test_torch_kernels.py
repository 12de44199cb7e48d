"""The port's two kernel modules against the JAX package's.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those against the reference's Pallas wrappers (interpret mode on the
CPU) and its jnp oracles, on the shapes, ragged widths and empty rows of
tests/test_kernels.py. Integer outputs must be exact. The sweep is bitwise
equal to both jnp oracles; against the Pallas wrapper in interpret mode it
is held at atol 1e-5, the tolerance the reference's own kernel tests use,
because XLA's CPU build of the interpreted kernel fuses γ·m into
multiply-adds (measured: up to 5e-7 apart on unit-scale costs). The
hand-written kernels are held against the plain versions on the card in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.message_passing import mp_sweep_reference as j_sweep_core  # noqa: E402,E501
from repro.kernels.cycle_intersect.ops import intersect_rows as j_isect  # noqa: E402,E501
from repro.kernels.cycle_intersect.ref import intersect_rows_ref as j_isect_ref  # noqa: E402,E501
from repro.kernels.triangle_mp.ops import mp_sweep as j_sweep  # noqa: E402
from repro.kernels.triangle_mp.ref import mp_sweep_ref as j_sweep_ref  # noqa: E402,E501
from repro_torch.core.message_passing import mp_sweep_reference  # noqa: E402
from repro_torch.kernels.cycle_intersect import ops as isect_ops  # noqa: E402
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref  # noqa: E402,E501
from repro_torch.kernels.triangle_mp import ops as sweep_ops  # noqa: E402
from repro_torch.kernels.triangle_mp.ref import mp_sweep_ref  # noqa: E402


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _costs(T, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, 3)) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# triangle_mp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1, 7, 128, 4097, 32768 + 3])
def test_sweep_plain_matches_reference_bitwise(T):
    x = _costs(T, seed=T)
    got = sweep_ops.mp_sweep(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, mp_sweep_ref(torch.from_numpy(x)))
    np.testing.assert_array_equal(
        got, mp_sweep_reference(torch.from_numpy(x)).numpy())
    for want in (j_sweep_ref(jnp.asarray(x)), j_sweep_core(jnp.asarray(x))):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # the reference's Pallas wrapper, interpret mode (see module note)
    np.testing.assert_allclose(got, np.asarray(j_sweep(jnp.asarray(x))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_sweep_plain_scales(scale):
    x = _costs(513, seed=3, scale=scale)
    got = sweep_ops.mp_sweep(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(j_sweep_ref(x)))


def test_sweep_cpu_launches_nothing():
    before = sweep_ops.launches
    sweep_ops.mp_sweep(torch.zeros(5, 3))
    assert sweep_ops.launches == before


# ---------------------------------------------------------------------------
# cycle_intersect
# ---------------------------------------------------------------------------

def _sorted_rows(key, R, W, n):
    """(R, W) windows of distinct sorted ids < n, padded with sentinel n."""
    rng = np.random.default_rng(key)
    rows = np.full((R, W), n, dtype=np.int32)
    for r in range(R):
        deg = rng.integers(0, min(W, n) + 1)
        rows[r, :deg] = np.sort(rng.choice(n, size=deg, replace=False))
    return rows


def _check_intersect(ci, cj):
    got = isect_ops.intersect_rows(torch.from_numpy(ci),
                                   torch.from_numpy(cj)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(j_isect_ref(ci, cj)))
    np.testing.assert_array_equal(got, np.asarray(j_isect(ci, cj)))


@pytest.mark.parametrize("R,W,Wj", [(1, 4, 4), (7, 33, 17), (64, 128, 128),
                                    (130, 96, 200), (9, 1, 1), (5, 130, 130),
                                    (16, 129, 257), (32, 8, 150),
                                    (8, 1, 300)])
def test_intersect_plain_matches_reference(R, W, Wj):
    n = max(W, Wj) + 9
    _check_intersect(_sorted_rows(R * 7 + W, R, W, n),
                     _sorted_rows(R * 7 + Wj + 1, R, Wj, n))


def test_intersect_semantics_and_empty_rows():
    ci = np.asarray([[3, 5, 9, 60]], np.int32)
    cj = np.asarray([[3, 3, 5, 8]], np.int32)
    got = intersect_rows_ref(torch.from_numpy(ci), torch.from_numpy(cj))
    np.testing.assert_array_equal(got.numpy(), [[1, 2, -1, -1]])
    n = 50
    empty_i = np.full((6, 40), n, np.int32)
    empty_j = np.full((6, 70), n, np.int32)
    _check_intersect(empty_i, empty_j)     # sentinels match sentinels
    _check_intersect(_sorted_rows(11, 6, 40, n), empty_j)


def test_intersect_unsorted_fan():
    """The 4-cycle chord test passes an unsorted fan as ``ci``."""
    rng = np.random.default_rng(5)
    cj = _sorted_rows(4, 32, 16, 40)
    ci = rng.integers(0, 41, size=(32, 4)).astype(np.int32)
    _check_intersect(ci, cj)
