"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test needs a CUDA device and skips without one; this file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cycle_intersect import ops as isect_ops  # noqa: E402
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref  # noqa: E402,E501
from repro_torch.kernels.triangle_mp import ops as sweep_ops  # noqa: E402
from repro_torch.kernels.triangle_mp.ref import mp_sweep_ref  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sorted_rows(key, R, W, n):
    """(R, W) windows of distinct sorted ids < n, padded with sentinel n."""
    rng = np.random.default_rng(key)
    rows = np.full((R, W), n, dtype=np.int32)
    for r in range(R):
        deg = rng.integers(0, min(W, n) + 1)
        rows[r, :deg] = np.sort(rng.choice(n, size=deg, replace=False))
    return torch.from_numpy(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 1000003, 1 << 20])
def test_sweep_kernel_bitwise(cuda_device, T):
    rng = np.random.default_rng(T)
    x = torch.from_numpy((rng.normal(size=(T, 3)) * 3).astype(np.float32))
    x = x.to(cuda_device)
    n0 = sweep_ops.launches
    got = sweep_ops.mp_sweep(x)
    assert sweep_ops.launches == n0 + 1
    want = mp_sweep_ref(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("R,W,Wj", [(256, 16, 16), (1024, 4, 128),
                                    (300, 37, 129), (8, 1, 20000)])
def test_intersect_kernel_exact(cuda_device, R, W, Wj):
    n = max(W, Wj) + 9
    ci = _sorted_rows(R + W, R, W, n).to(cuda_device)
    cj = _sorted_rows(R + Wj, R, Wj, n).to(cuda_device)
    n0 = isect_ops.launches
    got = isect_ops.intersect_rows(ci, cj)
    assert isect_ops.launches == n0 + 1
    assert torch.equal(got, intersect_rows_ref(ci, cj))


@pytest.mark.cuda
def test_intersect_kernel_empty_rows_and_fan(cuda_device):
    empty = torch.full((6, 40), 50, dtype=torch.int32, device=cuda_device)
    cj = torch.full((6, 70), 50, dtype=torch.int32, device=cuda_device)
    assert torch.equal(isect_ops.intersect_rows(empty, cj),
                       intersect_rows_ref(empty, cj))
    rng = np.random.default_rng(5)
    fan = torch.from_numpy(rng.integers(0, 41, size=(32, 4))
                           .astype(np.int32)).to(cuda_device)
    rows = _sorted_rows(4, 32, 16, 40).to(cuda_device)
    assert torch.equal(isect_ops.intersect_rows(fan, rows),
                       intersect_rows_ref(fan, rows))


def test_wrappers_raise_on_unsupported_input():
    """A CUDA tensor launches the kernel or raises — never falls back;
    other devices raise."""
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sweep_ops.mp_sweep(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        isect_ops.intersect_rows(meta.int(), meta.int())
    cpu = torch.zeros(2, 3, dtype=torch.int32)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="float32"):
            sweep_ops.mp_sweep(torch.zeros(4, 2, device="cuda"))
        with pytest.raises(ValueError, match="ci on"):
            isect_ops.intersect_rows(cpu, cpu.cuda())
    else:
        with pytest.raises(ValueError, match="ci on"):
            isect_ops.intersect_rows(cpu, meta.int())
