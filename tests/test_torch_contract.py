"""The contraction product of Lemma 4 in the port: the plain version of the
``contract_matmul`` kernel, the dense oracles ``adjacency_dense`` and
``contract_dense``, against the JAX package on the same numpy-made inputs,
and Lemma 4 itself inside the port.

The JAX ``contract_matmul`` runs its Pallas kernel in interpret mode on the
CPU, as ``tests/test_kernels.py`` runs it, at that file's five shapes and
its tolerance (atol 1e-3). The kernel on the card is held to the same
plain version in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``; its
arithmetic (3xTF32: the TF32 hi/lo split and three tensor-core products)
is emulated here on the CPU by ``ref.matmul_3xtf32`` and held to the same
gate.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import contraction as jct  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.kernels.contract_matmul import contract_matmul as j_contract_matmul  # noqa: E402,E501
from repro_torch.convert import instance_from_numpy  # noqa: E402
from repro_torch.core import contraction as tct  # noqa: E402
from repro_torch.kernels.contract_matmul import ops as cm_ops  # noqa: E402
from repro_torch.kernels.contract_matmul.ref import (  # noqa: E402
    contract_matmul_ref, matmul_3xtf32, matmul_ref, one_hot, split_tf32,
    tf32_round,
)

SHAPES = [(8, 3), (64, 17), (256, 256), (300, 77), (513, 100)]
# the card's gate on contract_matmul, max |diff| / max |ref|
# (chip_smoke.py's CONTRACT_REL_TOL, tests/test_torch_cuda.py's CM_REL_TOL)
CONTRACT_REL_TOL = 1e-5


def _case(N, M, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N, N)).astype(np.float32)
    A = (A + A.T) / 2
    f = rng.integers(0, M, N).astype(np.int32)
    return A, f


def _rel(got, want):
    """max |got - want| / max |want| (the card's gate, chip_smoke.py)."""
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("N,M", SHAPES)
def test_contract_matmul_matches_reference(N, M):
    A, f = _case(N, M, N * 1000 + M)
    want = np.asarray(j_contract_matmul(jnp.asarray(A), jnp.asarray(f), M))
    n0 = cm_ops.launches
    got = cm_ops.contract_matmul(torch.from_numpy(A), torch.from_numpy(f), M)
    assert cm_ops.launches == n0            # the CPU runs the plain version
    assert got.shape == (M, M) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert not got.diagonal().any()
    # the plain two-launch form against the one-expression oracle: the
    # products associate differently, so they agree to float32 rounding
    ref = contract_matmul_ref(torch.from_numpy(A), torch.from_numpy(f), M)
    assert _rel(got, ref) <= 1e-6


def test_contract_matmul_identity_mapping():
    """f = identity: contraction is a no-op up to the diagonal removal."""
    A, _ = _case(32, 32, 0)
    got = cm_ops.contract_matmul(torch.from_numpy(A), torch.arange(32), 32)
    want = A - np.diag(np.diag(A))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    jgot = j_contract_matmul(jnp.asarray(A), jnp.arange(32), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-4)


def test_contract_matmul_all_to_one():
    """Everything merges: a single live cluster, zero off-diagonal."""
    A, _ = _case(16, 4, 1)
    f = np.zeros(16, np.int32)
    got = cm_ops.contract_matmul(torch.from_numpy(A), torch.from_numpy(f), 4)
    np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-4)
    jgot = j_contract_matmul(jnp.asarray(A), jnp.asarray(f), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-4)


def test_matmul_wrapper_routes_and_checks():
    """The CPU runs the plain product and counts the shape, never a
    launch; ``drop_diag`` zeroes the global diagonal of a non-square
    output; bad shapes and other devices raise; ids outside [0, n_new)
    give zero one-hot rows, as ``jax.nn.one_hot`` does."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(7, 3)).astype(np.float32))
    n0, s0 = cm_ops.launches, cm_ops.shapes[(5, 7, 3)]
    out = cm_ops.matmul(x, y, drop_diag=True)
    assert cm_ops.launches == n0 and cm_ops.shapes[(5, 7, 3)] == s0 + 1
    want = matmul_ref(x, y)
    want[torch.arange(3), torch.arange(3)] = 0.0
    assert torch.equal(out, want)
    assert torch.equal(cm_ops.matmul(y.T, x.T), matmul_ref(y.T, x.T))
    with pytest.raises(ValueError, match="need"):
        cm_ops.matmul(x, x)
    meta = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cm_ops.matmul(meta, meta)
    with pytest.raises(ValueError, match="x on"):
        cm_ops.matmul(x, torch.empty((7, 3), device="meta"))
    oh = one_hot(torch.tensor([0, 2, 5, -1]), 3)
    np.testing.assert_array_equal(
        oh.numpy(), np.asarray(jnp.eye(3)[jnp.array([0, 2])].tolist()
                               + [[0, 0, 0], [0, 0, 0]]))


def _pair(ji):
    return instance_from_numpy(*[np.asarray(x) for x in ji], device="cpu")


@pytest.mark.parametrize("seed", range(2))
def test_dense_oracles_match_reference(seed):
    """``adjacency_dense`` and ``contract_dense`` against the reference on
    a contracted instance's mapping."""
    ji = jg.random_instance(20, 0.4, seed=seed, pad_edges=256, pad_nodes=24)
    jres = jct.contract(ji, jct.maximum_matching(ji))
    n_new = int(jres.n_new)
    jA = jct.adjacency_dense(ji)
    tA = tct.adjacency_dense(_pair(ji))
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=0, atol=0)
    jd = jct.contract_dense(jA, jres.mapping, n_new)
    td = tct.contract_dense(tA, torch.from_numpy(np.array(jres.mapping)),
                            n_new)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_contract_matches_dense_lemma4(seed):
    """Inside the port, as ``tests/test_contraction.py`` checks the
    reference: the sparse contraction equals the dense KᵀAK − diag of
    Lemma 4(a) on the live part, through ``contract_dense`` and through
    the kernel's wrapper (``contract_matmul``)."""
    ti = _pair(jg.random_instance(20, 0.4, seed=seed, pad_edges=256,
                                  pad_nodes=20))
    res = tct.contract(ti, tct.maximum_matching(ti))
    n_new = int(res.n_new)
    assert int(res.instance.node_valid.sum()) == n_new
    A = tct.adjacency_dense(ti)
    B = tct.adjacency_dense(res.instance)[:n_new, :n_new]
    for got in (tct.contract_dense(A, res.mapping, n_new),
                cm_ops.contract_matmul(A, res.mapping, n_new)):
        np.testing.assert_allclose(got.numpy()[:n_new, :n_new], B.numpy(),
                                   atol=1e-4)


def test_tf32_round_is_round_to_nearest_ties_away():
    """``tf32_round`` keeps 10 mantissa bits, rounds a tie away from zero
    (as ``cvt.rna.tf32.f32``), carries into the exponent, and passes
    infinities, NaNs and zeros through."""
    u = 2.0 ** -10                          # one TF32 ulp at 1.0
    x = torch.tensor([1.0, 1 + u / 2, 1 + u / 2 - 2 ** -23, 1 + 1.5 * u,
                      -(1 + u / 2), 2 - u / 2, 0.0, -0.0, float("inf"),
                      -float("inf"), 3.0e38], dtype=torch.float32)
    want = [1.0, 1 + u, 1.0, 1 + 2 * u, -(1 + u), 2.0, 0.0, -0.0,
            float("inf"), -float("inf")]
    got = tf32_round(x)
    assert got[:10].tolist() == want
    assert torch.signbit(got[7])
    assert int(got[10:].view(torch.int32)) & 0x1FFF == 0
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()
    # hi + lo keeps ~22 bits of x
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=4096).astype(np.float32))
    hi, lo = split_tf32(v)
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo), lo)
    assert float(((v - hi - lo).abs() / v.abs()).max()) <= 2.0 ** -21


def _contract_with(mm, A, f, M):
    """``ops.contract_matmul``'s two products, each through ``mm``."""
    K = one_hot(f, M, torch.float32)
    out = mm(K.T, mm(A, K))
    out.fill_diagonal_(0.0)
    return out


@pytest.mark.parametrize("N,M", SHAPES + [(2048, 512)])
def test_3xtf32_contraction_within_half_the_gate(N, M):
    """The kernel's arithmetic (3xTF32), emulated on the CPU, stays within
    half of the card's 1e-5 gate of the plain float32 contraction; a single
    TF32 pass (hi·hi only) on the same inputs exceeds the gate, so the gate
    tells the two apart."""
    A, f = _case(N, M, N * 1000 + M)
    A, f = torch.from_numpy(A), torch.from_numpy(f)
    want = cm_ops.contract_matmul(A, f, M)      # the CPU: matmul_ref
    got = _contract_with(matmul_3xtf32, A, f, M)
    assert _rel(got, want) <= CONTRACT_REL_TOL / 2
    one = _contract_with(lambda x, y: matmul_3xtf32(x, y, passes=1), A, f, M)
    assert _rel(one, want) > CONTRACT_REL_TOL
