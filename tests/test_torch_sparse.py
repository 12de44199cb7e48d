"""The port's sparse substrate (``repro_torch.sparse``) against the JAX
package's (``repro.sparse``), on the CPU, on the same numpy inputs.

Tolerances. Integers and booleans exactly equal: ``coo_dedupe_sum``'s
u, v, valid and n_unique, ``segment_argmax`` (ties and empty segments),
``canonical_edge_key``, and the sampler's blocks (``sample`` and
``sample_padded`` array-equal: the port keeps its own numpy copy with the
same ``default_rng((seed, step))``). Floats rtol 1e-5 (atol 1e-6 for
values near 0): segment max/min/mean/softmax, ``spmm`` with sum, max and
mean, ``sddmm``, ``gather_scatter_mp`` and ``embedding_bag`` in every
mode, ragged too (the port sums with ``index_add``; the reference's
scatter-add order may differ).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

# the packages export functions named as their modules: take the modules
jeb = importlib.import_module("repro.sparse.embedding_bag")
jsamp = importlib.import_module("repro.sparse.sampler")
jseg = importlib.import_module("repro.sparse.segment_ops")
jspmm = importlib.import_module("repro.sparse.spmm")
teb = importlib.import_module("repro_torch.sparse.embedding_bag")
tsamp = importlib.import_module("repro_torch.sparse.sampler")
tseg = importlib.import_module("repro_torch.sparse.segment_ops")
tspmm = importlib.import_module("repro_torch.sparse.spmm")

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def seg_inputs():
    rng = np.random.default_rng(0)
    n, S = 300, 23
    ids = rng.integers(0, S, n).astype(np.int32)
    ids[ids == 5] = 6                     # segment 5 stays empty
    vals = rng.normal(size=(n, 4)).astype(np.float32)
    mask = rng.random(n) < 0.8
    return n, S, ids, vals, mask


@pytest.mark.parametrize("fn", ["segment_max", "segment_min",
                                "segment_mean"])
@pytest.mark.parametrize("rank", [1, 2])
def test_segment_reductions_match(seg_inputs, fn, rank):
    """Floats (n,) and rows (n, 4), empty segment included (-inf / +inf
    for max / min, as ``jax.ops.segment_max``; 0 for the mean)."""
    _, S, ids, vals, _ = seg_inputs
    v = vals[:, 0] if rank == 1 else vals
    got = getattr(tseg, fn)(_t(v), _t(ids), S)
    want = getattr(jseg, fn)(jnp.asarray(v), jnp.asarray(ids), S)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches(seg_inputs, masked):
    _, S, ids, vals, mask = seg_inputs
    m = mask if masked else None
    got = tseg.segment_softmax(_t(vals[:, 0]), _t(ids), S,
                               mask=None if m is None else _t(m))
    want = jseg.segment_softmax(jnp.asarray(vals[:, 0]), jnp.asarray(ids),
                                S, mask=m)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_segment_argmax_ties_and_empty_segments():
    """Ties go to the smallest index; an empty or fully masked segment
    gives -1 and -inf; exactly the reference's."""
    rng = np.random.default_rng(1)
    n, S = 200, 30
    vals = np.round(rng.normal(size=n), 1).astype(np.float32)   # ties
    ids = rng.integers(0, S - 3, n).astype(np.int32)            # 3 empty
    mask = rng.random(n) < 0.6
    for m in (None, mask):
        got = tseg.segment_argmax(_t(vals), _t(ids), S,
                                  mask=None if m is None else _t(m))
        want = jseg.segment_argmax(vals, ids, S, mask=m)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(_np(x), np.asarray(y))
        assert int((_np(got[0]) == -1).sum()) >= 3


def test_canonical_edge_key_exact():
    rng = np.random.default_rng(2)
    u = rng.integers(0, 1000, 500).astype(np.int32)
    v = rng.integers(0, 1000, 500).astype(np.int32)
    got = tseg.canonical_edge_key(_t(u), _t(v), 1000)
    want = jseg.canonical_edge_key(jnp.asarray(u), jnp.asarray(v), 1000)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(got), _np(tseg.canonical_edge_key(_t(v), _t(u), 1000)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coo_dedupe_sum_exact(seed):
    """Parallel edges in both orientations, self loops and invalid rows:
    u, v, valid and n_unique exactly equal, w within rtol 1e-5."""
    rng = np.random.default_rng(seed)
    E, N = 257, 40
    u = rng.integers(0, N, E).astype(np.int32)
    v = rng.integers(0, N, E).astype(np.int32)
    flip = rng.random(E) < 0.5
    u[flip], v[flip] = v[flip], u[flip]
    w = rng.normal(size=E).astype(np.float32)
    valid = rng.random(E) < 0.85
    got = tseg.coo_dedupe_sum(_t(u), _t(v), _t(w), _t(valid), N)
    want = jseg.coo_dedupe_sum(jnp.asarray(u), jnp.asarray(v),
                               jnp.asarray(w), jnp.asarray(valid), N)
    for name, a, b in zip(("u", "v", "valid", "n_unique"),
                          (got[0], got[1], got[3], got[4]),
                          (want[0], want[1], want[3], want[4])):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
        assert _np(a).dtype == np.asarray(b).dtype, name
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), **TOL)
    assert 0 < int(got[4]) < E


@pytest.fixture(scope="module")
def graph_inputs():
    rng = np.random.default_rng(3)
    N, E, d = 37, 150, 6
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N - 4, E).astype(np.int32)   # 4 nodes get none
    x = rng.normal(size=(N, d)).astype(np.float32)
    w = rng.normal(size=E).astype(np.float32)
    b = rng.normal(size=(N, d)).astype(np.float32)
    return N, src, dst, x, w, b


@pytest.mark.parametrize("reduce", ["sum", "max", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_matches(graph_inputs, reduce, weighted):
    N, src, dst, x, w, _ = graph_inputs
    ew = w if weighted else None
    got = tspmm.spmm(_t(src), _t(dst), None if ew is None else _t(ew),
                     _t(x), N, reduce=reduce)
    want = jspmm.spmm(jnp.asarray(src), jnp.asarray(dst),
                      None if ew is None else jnp.asarray(ew),
                      jnp.asarray(x), N, reduce=reduce)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_sddmm_and_gather_scatter_match(graph_inputs):
    N, src, dst, x, w, b = graph_inputs
    np.testing.assert_allclose(
        _np(tspmm.sddmm(_t(src), _t(dst), _t(x), _t(b))),
        np.asarray(jspmm.sddmm(jnp.asarray(src), jnp.asarray(dst),
                               jnp.asarray(x), jnp.asarray(b))), **TOL)
    ef = w[:, None]

    def t_msg(hs, hd, e):
        return torch.tanh(hs - hd) * e

    def j_msg(hs, hd, e):
        return jnp.tanh(hs - hd) * e

    np.testing.assert_allclose(
        _np(tspmm.gather_scatter_mp(_t(src), _t(dst), _t(ef), _t(x), t_msg,
                                    N)),
        np.asarray(jspmm.gather_scatter_mp(
            jnp.asarray(src), jnp.asarray(dst), jnp.asarray(ef),
            jnp.asarray(x), j_msg, N)), **TOL)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_bag_matches(mode, masked):
    """(B, F, bag) bags; with a mask, one bag fully masked (0 in every
    mode, as the reference's ``max`` gives)."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.integers(0, 50, (6, 3, 4)).astype(np.int32)
    mask = rng.random((6, 3, 4)) < 0.6
    mask[2, 1] = False
    m = mask if masked else None
    got = teb.embedding_bag(_t(table), _t(idx),
                            None if m is None else _t(m), mode=mode)
    want = jeb.embedding_bag(jnp.asarray(table), jnp.asarray(idx), m,
                             mode=mode)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    if masked:
        assert not _np(got)[2, 1].any()


def test_embedding_bag_ragged_and_gradient():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(30, 5)).astype(np.float32)
    flat = rng.integers(0, 30, 40).astype(np.int32)
    bags = np.sort(rng.integers(0, 9, 40)).astype(np.int32)
    got = teb.embedding_bag_ragged(_t(table), _t(flat), _t(bags), 10)
    want = jeb.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat),
                                    jnp.asarray(bags), 10)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the table's gradient is dense, as the reference's
    tt = _t(table).requires_grad_()
    teb.embedding_bag(tt, _t(flat.reshape(8, 5)), mode="sum").sum().backward()
    jg = jax.grad(lambda t: jeb.embedding_bag(t, flat.reshape(8, 5)).sum())(
        jnp.asarray(table))
    assert tt.grad.layout == torch.strided
    np.testing.assert_allclose(_np(tt.grad), np.asarray(jg), **TOL)


def _csr_pair(seed):
    rng = np.random.default_rng(seed)
    N, E = 60, 400
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    src[:5] = 59                           # one hub of small degree
    return (tsamp.CSRGraph.from_edges(src, dst, N),
            jsamp.CSRGraph.from_edges(src, dst, N), N)


@pytest.mark.parametrize("seed,step", [(0, 0), (1, 7), (5, 123)])
def test_sampler_identical(seed, step):
    """``sample`` and ``sample_padded``: every array equal to the JAX
    module's for the same graph, seeds, seed and step."""
    tg, jg, N = _csr_pair(seed)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    seeds = np.random.default_rng(seed + 10).choice(N, 6, replace=False)
    ts = tsamp.NeighborSampler(tg, (4, 3), seed=seed)
    js = jsamp.NeighborSampler(jg, (4, 3), seed=seed)
    tb, jb = ts.sample(seeds, step), js.sample(seeds, step)
    assert len(tb) == len(jb) == 2
    for a, b in zip(tb, jb):
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
    tp = ts.sample_padded(seeds, step, (40, 40, 40))
    jp = js.sample_padded(seeds, step, (40, 40, 40))
    assert tp.keys() == jp.keys()
    for k in tp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
        assert tp[k].dtype == jp[k].dtype, k
