"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test needs a CUDA device and skips without one; this file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.contract_matmul import ops as cm_ops  # noqa: E402
from repro_torch.kernels.contract_matmul.ref import contract_matmul_ref, \
    matmul_ref  # noqa: E402
from repro_torch.kernels.cycle_intersect import ops as isect_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.chunked import chunked_attention  # noqa: E402,E501
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref  # noqa: E402,E501
from repro_torch.kernels.triangle_mp import ops as sweep_ops  # noqa: E402
from repro_torch.kernels.triangle_mp.ref import mp_phase_ref, \
    mp_sweep_ref  # noqa: E402


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
@pytest.mark.parametrize("T,offset", [(4096, 1), (4099, 0), (1023, 0)])
def test_sweep_kernel_unaligned_and_tail(cuda_device, T, offset):
    """A view that starts 12 bytes into its storage takes the 4-byte path;
    a ragged last tile (T % 1024 != 0) is masked; both give the bits of
    the plain version."""
    rng = np.random.default_rng(T + offset)
    base = torch.from_numpy((rng.normal(size=(T + offset, 3)) * 3)
                            .astype(np.float32)).to(cuda_device)
    x = base[offset:]
    got = sweep_ops.mp_sweep(x)
    assert torch.equal(got.view(torch.int32),
                       mp_sweep_ref(x).view(torch.int32))


def _phase_inputs(T, E, n_valid, seed, share=2):
    """Triangles over E edges, ``n_valid`` of T rows valid (spread), their
    edge ids drawn from ``3 * n_valid // share`` edges, so an edge sits in
    up to ~share * 4 triangles; invalid rows zeroed; one edge cost -0.0
    and one in 16 edges invalid."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(E, size=max(3, 3 * n_valid // share), replace=False)
    tri = pool[rng.integers(0, pool.size, size=(T, 3))].astype(np.int32)
    valid = np.zeros(T, dtype=bool)
    valid[rng.choice(T, size=n_valid, replace=False)] = True
    tri[~valid] = 0
    cost = (rng.normal(size=E) * 3).astype(np.float32)
    cost[np.setdiff1d(np.arange(E), pool)[:1]] = -0.0
    ev = rng.random(E) >= 1 / 16
    return [torch.from_numpy(a) for a in (cost, ev, tri, valid)]


def _bits_equal(got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,n_valid", [(1024, 40000, 128),
                                         (2048, 40000, 200),
                                         (1999, 5000, 1500), (37, 200, 30),
                                         (1 << 20, 1 << 22, 1 << 20),
                                         (3000, 9000, 0)])
def test_phase_kernel_bitwise(cuda_device, T, E, n_valid):
    """The fused MP phase equals its plain version bit for bit (t_cost,
    c_rep, lb) on the card: one launch of one block up to T = 2 048, a
    launch per pass and a landing beyond (T = 2^20 and 3 000, the last
    with no valid row)."""
    args = [a.to(cuda_device) for a in _phase_inputs(T, E, n_valid, T)]
    n0 = sweep_ops.launches
    got = sweep_ops.mp_phase(*args, 5)
    assert sweep_ops.launches == n0 + (1 if T <= sweep_ops.FUSED_MAX_T
                                       else 6)
    assert _bits_equal(got, mp_phase_ref(*args, 5))


@pytest.mark.cuda
def test_phase_kernel_on_a_side_stream(cuda_device):
    """Both entry points launch on PyTorch's current stream: under
    ``torch.cuda.stream(s)`` the results are right once ``s`` is
    synchronised."""
    args = [a.to(cuda_device) for a in _phase_inputs(1024, 9000, 300, 3)]
    x = torch.randn(5000, 3, device=cuda_device)
    want = mp_phase_ref(*args, 5), mp_sweep_ref(x)
    torch.cuda.synchronize()
    s = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(s):
        got = sweep_ops.mp_phase(*args, 5), sweep_ops.mp_sweep(x)
    s.synchronize()
    assert _bits_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


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


@pytest.mark.cuda
def test_intersect_kernel_on_a_side_stream(cuda_device):
    """The launch goes to PyTorch's current stream: under
    ``torch.cuda.stream(s)`` the result is right once ``s`` is
    synchronised, and the call counts one launch."""
    ci = _sorted_rows(1, 32, 128, 200).to(cuda_device)
    cj = _sorted_rows(2, 32, 128, 200).to(cuda_device)
    want = intersect_rows_ref(ci, cj)
    torch.cuda.synchronize()
    s = torch.cuda.Stream(device=cuda_device)
    n0 = isect_ops.launches
    with torch.cuda.stream(s):
        got = isect_ops.intersect_rows(ci, cj)
    s.synchronize()
    assert isect_ops.launches == n0 + 1
    assert torch.equal(got, want)


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
        c = torch.zeros(5, device="cuda")
        with pytest.raises(ValueError, match="int32"):
            sweep_ops.mp_phase(c, c > 0, torch.zeros(2, 3, device="cuda"),
                               torch.ones(2, dtype=torch.bool,
                                          device="cuda"), 5)
        with pytest.raises(ValueError, match="ci on"):
            isect_ops.intersect_rows(cpu, cpu.cuda())
    else:
        with pytest.raises(ValueError, match="ci on"):
            isect_ops.intersect_rows(cpu, meta.int())


# (B, Hq, Hkv, S, D, causal, window, softcap): gemma2's global and local
# layers (GQA 16/8, D 256, softcap 50), MHA at D 96, MQA at D 128, S = 1,
# ragged S, non-causal with and without a window; then chip_smoke.py's
# cases for the kernel's tiling (BQ = 128 query rows, BK = 80 keys at
# D = 256): a window narrower than a key tile, S one past a query block,
# Hq = Hkv at D 256 with softcap, D 96 with a window
FLASH_CASES = [
    (1, 16, 8, 1024, 256, True, None, 50.0),
    (1, 16, 8, 1024, 256, True, 256, 50.0),
    (2, 4, 4, 333, 96, True, None, None),
    (1, 6, 1, 200, 128, True, None, None),
    (1, 4, 2, 1, 128, True, None, None),
    (1, 4, 2, 130, 256, False, None, None),
    (1, 4, 2, 300, 128, False, 50, 20.0),
    (1, 2, 1, 37, 96, True, 8, None),
    (1, 16, 8, 1000, 256, True, 17, 50.0),
    (1, 16, 8, 129, 256, True, None, 50.0),
    (1, 16, 16, 2048, 256, True, None, 50.0),
    (1, 32, 32, 2048, 96, True, 512, None),
]
# bf16 output: one bf16 ulp is 2^-7 relative (<= 0.0078 below 1, 0.0156 in
# [2, 4)); the kernel rounds P to bf16 for its P V product where the plain
# version keeps f32, which moves an output by well under one ulp on average
FLASH_TOL = dict(atol=1e-2, rtol=1e-2)


def _qkv(B, Hq, Hkv, S, D, seed, device):
    rng = np.random.default_rng(seed)

    def t(h, scale):
        x = rng.normal(size=(B, h, S, D)).astype(np.float32) * scale
        return torch.from_numpy(x).to(device, torch.bfloat16)
    return t(Hq, 2.0), t(Hkv, 1.0), t(Hkv, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_against_chunked(cuda_device, case):
    B, Hq, Hkv, S, D, causal, window, softcap = case
    q, k, v = _qkv(B, Hq, Hkv, S, D, S + D, cuda_device)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n0 = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_ops.launches == n0 + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = chunked_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[2]], ids=str)
def test_flash_kernel_is_deterministic(cuda_device, case):
    """Two launches on the same inputs give the same bits (no atomics;
    every sum in one fixed order)."""
    B, Hq, Hkv, S, D, causal, window, softcap = case
    q, k, v = _qkv(B, Hq, Hkv, S, D, 11, cuda_device)
    kw = dict(causal=causal, window=window, softcap=softcap)
    assert torch.equal(flash_ops.flash_attention(q, k, v, **kw),
                       flash_ops.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
def test_flash_kernel_build_report(cuda_device, tmp_path, monkeypatch):
    """ptxas's report of a fresh build: every kernel function (D 96, 128,
    256, with and without softcap) spills nothing, and ptxas neither
    serialized its wgmma (notes C7514, C7518) nor ignored its setmaxnreg
    (C7508)."""
    from repro_torch.kernels import _build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    _build.build_all(["flash_attention"])
    rows = _build.ptxas_report("flash_attention")
    assert sorted(r["function"] for r in rows) == sorted(
        f"flash_fwd_kernel<{d}, {c}>" for d in (96, 128, 256) for c in (0, 1))
    for r in rows:
        assert r["spill_stores"] == r["spill_loads"] == r["stack"] == 0, r
        assert not set(r["notes"]) & {"C7508", "C7514", "C7518"}, r


@pytest.mark.cuda
def test_flash_kernel_reads_strided_inputs(cuda_device):
    """q, k, v as the transformer makes them, (B, S, H, D) transposed to
    (B, H, S, D), give the same bits as contiguous copies."""
    rng = np.random.default_rng(3)

    def t(h):
        x = rng.normal(size=(2, 100, h, 128)).astype(np.float32)
        return torch.from_numpy(x).to(cuda_device, torch.bfloat16) \
            .transpose(1, 2)
    q, k, v = t(8), t(2), t(2)
    a = flash_ops.flash_attention(q, k, v, window=33, softcap=30.0)
    b = flash_ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=33, softcap=30.0)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_kernel_raises_on_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(1, 2, 1, 16, 64, 0, cuda_device)
    with pytest.raises(ValueError, match="head dim 64"):
        flash_ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 2, 1, 16, 128, 0, cuda_device)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_ops.flash_attention(q.float(), k.float(), v.float())


def test_flash_wrapper_raises_without_a_kernel_route():
    """Other devices, gradients, unknown backends and bad masks raise;
    nothing falls back quietly."""
    meta = torch.empty((1, 2, 8, 128), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_ops.flash_attention(meta, meta[:, :1], meta[:, :1])
    q = torch.zeros((1, 2, 8, 16), requires_grad=True)
    k = torch.zeros((1, 1, 8, 16))
    with pytest.raises(NotImplementedError, match="item 15"):
        flash_ops.flash_attention(q, k, k)
    with torch.no_grad():
        out = flash_ops.flash_attention(q, k, k)
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="unknown backend"):
        flash_ops.flash_attention(k, k, k, backend="pallas")
    with pytest.raises(ValueError, match="window"):
        flash_ops.flash_attention(k, k, k, window=0)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        kv2 = torch.zeros((1, 2, 8, 16))
        flash_ops.flash_attention(torch.zeros((1, 3, 8, 16)), kv2, kv2)


# contract_matmul: 3xTF32 on the tensor cores (lo·hi + hi·lo + hi·hi of the
# operands' TF32 splits, float32 accumulation), summed in another order than
# cuBLAS's full-float32 product; a single TF32 product would sit near 1e-4
# of max |ref| and fail this gate
CM_REL_TOL = 1e-5


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("N,M", [(8, 3), (64, 17), (256, 256), (300, 77),
                                 (513, 100), (2048, 512)])
def test_contract_matmul_kernel_against_plain(cuda_device, N, M):
    rng = np.random.default_rng(N * 1000 + M)
    A = rng.normal(size=(N, N)).astype(np.float32)
    A = torch.from_numpy((A + A.T) / 2).to(cuda_device)
    f = torch.from_numpy(rng.integers(0, M, N).astype(np.int32)) \
        .to(cuda_device)
    n0, s0 = cm_ops.launches, cm_ops.split_launches
    got = cm_ops.contract_matmul(A, f, M)
    torch.cuda.synchronize()
    assert cm_ops.launches == n0 + 2
    assert cm_ops.split_launches == s0 + 4
    want = contract_matmul_ref(A, f, M)
    assert got.shape == (M, M) and not bool(got.diagonal().any())
    assert _rel(got, want) <= CM_REL_TOL


@pytest.mark.cuda
def test_contract_matmul_kernel_is_deterministic(cuda_device):
    """Two launches on the same inputs give the same bits (no split-K, no
    atomics: each output element is summed in one fixed order)."""
    rng = np.random.default_rng(9)
    A = torch.from_numpy(rng.normal(size=(2048, 2048)).astype(np.float32)) \
        .to(cuda_device)
    f = torch.from_numpy(rng.integers(0, 512, 2048).astype(np.int32)) \
        .to(cuda_device)
    assert torch.equal(cm_ops.contract_matmul(A, f, 512),
                       cm_ops.contract_matmul(A, f, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("name,functions", [
    ("contract_matmul", ["contract_product_kernel", "contract_split_kernel"]),
    ("cycle_intersect", ["cycle_intersect_kernel<0, 0>",
                         "cycle_intersect_kernel<1, 0>",
                         "cycle_intersect_kernel<1, 1>"]),
    ("triangle_mp", ["triangle_mp_sweep_kernel<0>",
                     "triangle_mp_sweep_kernel<1>",
                     "triangle_mp_phase_kernel", "triangle_mp_pass_kernel",
                     "triangle_mp_land_kernel"])])
def test_kernel_build_report(cuda_device, tmp_path, monkeypatch, name,
                             functions):
    """ptxas's report of a fresh build of the redesigned kernels: every
    function spills nothing, and ptxas neither serialized a wgmma (notes
    C7514, C7518) nor ignored a setmaxnreg (C7508)."""
    from repro_torch.kernels import _build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    _build.build_all([name])
    rows = _build.ptxas_report(name)
    assert sorted(r["function"] for r in rows) == sorted(functions)
    for r in rows:
        assert r["spill_stores"] == r["spill_loads"] == r["stack"] == 0, r
        assert not set(r["notes"]) & {"C7508", "C7514", "C7518"}, r


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (7, 13, 5), (129, 9, 130),
                                   (300, 1000, 77), (128, 256, 384),
                                   (129, 64, 129), (257, 1023, 130)])
def test_matmul_kernel_strides_tails_and_diagonal(cuda_device, M, K, N):
    """Ragged M, N and K (K = 13 and 1023 are not multiples of 4, the
    planes' row pitch; 129 and 257 are one past a 128-row or -column
    tile); inputs read through transposed strides give the same bits as
    contiguous copies; the epilogue zeroes exactly the global diagonal."""
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)) \
        .to(cuda_device)
    y = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)) \
        .to(cuda_device)
    got = cm_ops.matmul(x, y)
    assert _rel(got, matmul_ref(x, y)) <= CM_REL_TOL
    xt = x.T.contiguous().T                 # (M, K) with strides (1, M)
    yt = y.T.contiguous().T
    assert torch.equal(cm_ops.matmul(xt, yt), got)
    dd = cm_ops.matmul(x, y, drop_diag=True)
    n = min(M, N)
    assert not bool(dd.diagonal().any())
    off = ~torch.eye(M, N, dtype=torch.bool, device=cuda_device)
    assert torch.equal(dd[off], got[off])
    assert n == dd.diagonal().numel()


@pytest.mark.cuda
def test_fixed_order_sums_card_equals_cpu(cuda_device):
    """The port's float segment sums give the CPU's bits on the card."""
    from repro_torch.sparse.segment_ops import segment_sum
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.normal(size=200000).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 50000, 200000))
    cpu = segment_sum(vals, ids, 50000)
    card = segment_sum(vals.to(cuda_device), ids.to(cuda_device), 50000)
    assert torch.equal(card.cpu(), cpu)
