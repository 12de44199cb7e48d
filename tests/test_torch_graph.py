"""The port's graph and segment modules against the JAX package's: instance
building and its errors, the shared numpy generators, CSR build / filter /
windows / lookup (all exact), and the segment reductions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jg  # noqa: E402
from repro.sparse import segment_ops as jseg  # noqa: E402
from repro_torch.convert import instance_from_numpy  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.sparse import segment_ops as tseg  # noqa: E402

CPU = "cpu"


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_instance(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(x), _np(y))


FAMILIES = [
    ("grid", lambda m, **k: m.grid_instance(12, 13, seed=3, **k)),
    ("random", lambda m, **k: m.random_instance(40, 0.2, seed=1, **k)),
    ("cluster", lambda m, **k: m.cluster_instance(50, seed=2, **k)),
]


@pytest.mark.parametrize("name,gen", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_generators_identical_to_reference(name, gen):
    """Both packages draw from np.random.default_rng: same seed, same
    instance, padding included."""
    _same_instance(gen(tg, pad_edges=900, pad_nodes=200, device=CPU),
                   gen(jg, pad_edges=900, pad_nodes=200))


def test_make_instance_merges_and_validates():
    u, v, c = [0, 1, 2, 1], [1, 0, 3, 2], [1.0, 2.0, -1.0, 0.5]
    _same_instance(tg.make_instance(u, v, c, 4, pad_edges=8, device=CPU),
                   jg.make_instance(u, v, c, 4, pad_edges=8))
    with pytest.raises(ValueError, match="equal length"):
        tg.make_instance([0, 1], [1], [1.0, 2.0], 3, device=CPU)
    with pytest.raises(ValueError, match="node ids must lie"):
        tg.make_instance([0, 5], [1, 2], [1.0, 2.0], 3, device=CPU)
    with pytest.raises(ValueError, match="self-loops"):
        tg.make_instance([1], [1], [2.0], 3, device=CPU)
    tg.make_instance([1], [1], [0.0], 3, device=CPU)   # zero-cost filler ok


def test_addressing_policy():
    assert tg.offset_dtype(1000) == torch.int32
    assert tg.offset_dtype(2 ** 30 + 1) == torch.int64
    assert tg.index_dtype(2 ** 31) == torch.int64
    tg.check_edge_addressing(2 ** 31 - 1)
    with pytest.raises(ValueError, match="int64 edge ids"):
        tg.check_edge_addressing(2 ** 31)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert tg.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tg.make_instance([0], [1], [1.0], 2)
    assert tg.resolve_device("cpu").type == "cpu"


def test_graph_impl_and_p95():
    for impl, n in [("auto", 100), ("auto", 300), ("sparse", 10),
                    ("dense", 999)]:
        assert tg.resolve_graph_impl(impl, n) == \
            jg.resolve_graph_impl(impl, n)
    with pytest.raises(ValueError):
        tg.resolve_graph_impl("bogus", 10)
    ji = jg.grid_instance(9, 11, seed=4, pad_nodes=120)
    ti = instance_from_numpy(*[np.asarray(x) for x in ji], device=CPU)
    assert tg.attractive_degree_p95(ti) == jg.attractive_degree_p95(ji)


def _pair(seed=0, pad_edges=700):
    ji = jg.random_instance(45, 0.25, seed=seed, pad_edges=pad_edges,
                            pad_nodes=50)
    ti = instance_from_numpy(*[np.asarray(x) for x in ji], device=CPU)
    return ji, ti


def _same_csr(t, j):
    for x, y in zip(t, j):
        np.testing.assert_array_equal(_np(x).astype(np.int64),
                                      np.asarray(y).astype(np.int64))


@pytest.mark.parametrize("attractive_only", [False, True])
def test_build_csr_exact(attractive_only):
    ji, ti = _pair(seed=3)
    _same_csr(tg.csr_from_instance(ti, attractive_only),
              jg.csr_from_instance(ji, attractive_only))


def test_build_csr_duplicate_edges_order():
    """Parallel copies sort by edge id, so lookups resolve to the largest
    id — only reachable through build_csr directly (instances dedupe)."""
    u = np.array([0, 1, 0, 2, 0], np.int32)
    v = np.array([1, 2, 1, 0, 2], np.int32)
    mask = np.array([True, True, True, True, False])
    tc = tg.build_csr(torch.from_numpy(u), torch.from_numpy(v),
                      torch.from_numpy(mask), 3)
    jc = jg.build_csr(jnp.asarray(u), jnp.asarray(v), jnp.asarray(mask), 3)
    _same_csr(tc, jc)
    a = torch.tensor([0, 1, 2, 0])
    b = torch.tensor([1, 0, 0, 2])
    want = jax.vmap(lambda x, y: jg.csr_lookup_edge(jc, x, y))(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    np.testing.assert_array_equal(tg.csr_lookup_edge(tc, a, b).numpy(),
                                  np.asarray(want))


def test_csr_filter_windows_lookup_exact():
    ji, ti = _pair(seed=5)
    jall, tall = jg.csr_from_instance(ji), tg.csr_from_instance(ti)
    keep = np.array(ji.edge_valid & (ji.cost > 0))
    jpos = jg.csr_filter(jall, jnp.asarray(keep))
    tpos = tg.csr_filter(tall, torch.from_numpy(keep))
    _same_csr(tpos, jpos)
    _same_csr(tpos, jg.csr_from_instance(ji, attractive_only=True))
    N = ti.num_nodes
    nodes = np.array([0, 3, N - 1, N, 17], np.int32)   # N = empty fan slot
    for cap in (1, 4, 16):
        got = tg.csr_row_window(tpos, torch.from_numpy(nodes), cap)
        want = jax.vmap(lambda n: jg.csr_row_window(jpos, n, cap))(
            jnp.asarray(nodes))
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    rng = np.random.default_rng(0)
    a = rng.integers(0, N, 300).astype(np.int32)
    b = rng.integers(0, N + 1, 300).astype(np.int32)
    got = tg.csr_lookup_edge(tall, torch.from_numpy(a), torch.from_numpy(b))
    want = jax.vmap(lambda x, y: jg.csr_lookup_edge(jall, x, y))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).any()


def test_lexsort_matches_numpy():
    rng = np.random.default_rng(1)
    keys = [rng.integers(0, 4, 200).astype(np.int32) for _ in range(3)]
    got = tg.lexsort([torch.from_numpy(k) for k in keys]).numpy()
    np.testing.assert_array_equal(got, np.lexsort(keys))


def test_segment_ops_match_reference():
    rng = np.random.default_rng(2)
    n, S = 400, 37
    vals = rng.normal(size=n).astype(np.float32)
    ids = rng.integers(-2, S + 3, n).astype(np.int32)   # some dropped
    ivals = rng.integers(-50, 50, n).astype(np.int32)
    tv, ti_, tiv = map(torch.from_numpy, (vals, ids, ivals))
    # fixed-order float sum: bitwise equal to the sequential scatter-add
    np.testing.assert_array_equal(
        _np(tseg.segment_sum(tv, ti_, S)),
        np.asarray(jax.ops.segment_sum(vals, ids, num_segments=S)))
    for tf, jf in [(tseg.segment_max, jseg.segment_max),
                   (tseg.segment_min, jseg.segment_min),
                   (tseg.segment_sum, jseg.segment_sum)]:
        np.testing.assert_array_equal(_np(tf(tiv, ti_, S)),
                                      np.asarray(jf(ivals, ids, S)))
    np.testing.assert_array_equal(_np(tseg.segment_max(tv, ti_, S)),
                                  np.asarray(jseg.segment_max(vals, ids, S)))
    ok = ids >= 0
    ids_ok = np.where(ok, ids, 0).astype(np.int32)
    vals_t = np.round(vals, 1)            # force ties: smallest index wins
    mask = rng.random(n) < 0.7
    got = tseg.segment_argmax(torch.from_numpy(vals_t),
                              torch.from_numpy(ids_ok), S + 4,
                              mask=torch.from_numpy(mask))
    want = jseg.segment_argmax(vals_t, ids_ok, S + 4, mask=mask)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_np(x), np.asarray(y))


def _sequential_reference(vals, ids, S):
    """float32 sums in input order, one addition at a time from 0.0."""
    out = np.zeros(S, np.float32)
    for v, i in zip(vals, ids):
        if 0 <= i < S:
            out[i] = np.float32(out[i] + v)
    return out


def test_fixed_order_sums_are_sequential():
    """The port's float segment sums and the contraction's merged-cost sum
    add each segment in input order, one entry at a time from 0.0, also
    for long segments — the order a card must reproduce (on CUDA
    ``torch.segment_reduce`` sums in another order)."""
    from repro_torch.core.contraction import _fixed_order_run_sum
    rng = np.random.default_rng(5)
    n, S = 3000, 23                     # ~130 entries a segment
    vals = (rng.normal(size=n) * 10 ** rng.uniform(-3, 3, n)) \
        .astype(np.float32)
    ids = rng.integers(-1, S + 1, n).astype(np.int32)
    got = tseg.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), S)
    np.testing.assert_array_equal(_np(got), _sequential_reference(vals, ids,
                                                                  S))
    # run sum: entries (is_entry) carry nondecreasing segment ids
    is_entry = rng.random(n) < 0.6
    seg = np.sort(rng.integers(0, S, n)).astype(np.int32)
    got = _fixed_order_run_sum(torch.from_numpy(vals), torch.from_numpy(seg),
                               torch.from_numpy(is_entry), S)
    np.testing.assert_array_equal(
        _np(got), _sequential_reference(vals[is_entry], seg[is_entry], S))


def _chunks(u, v, c, size):
    for i in range(0, len(u), size):
        yield u[i:i + size], v[i:i + size], c[i:i + size]


def test_make_instance_streamed_equals_the_generator():
    """Streaming a generator's host edges in chunks rebuilds its padded
    instance leaf for leaf; peak host slots are the buffer plus one chunk;
    the reference's ingest builds the same arrays."""
    inst = tg.grid_instance(12, 13, seed=3, pad_edges=700, device=CPU)
    u, v, c = tg.to_host_edges(inst)
    assert (u.dtype, v.dtype, c.dtype) == (np.int32, np.int32, np.float32)
    n = int(inst.edge_valid.sum())
    got, stats = tg.make_instance_streamed(_chunks(u, v, c, 64), 156,
                                           pad_edges=inst.num_edges,
                                           device=CPU)
    _same_instance(got, inst)
    assert stats == tg.StreamStats(n_chunks=-(-n // 64), n_edges=n,
                                   peak_host_elems=inst.num_edges + 64)
    ji = jg.grid_instance(12, 13, seed=3, pad_edges=700)
    jgot, jstats = jg.make_instance_streamed(
        _chunks(*jg.to_host_edges(ji), 64), 156, pad_edges=700)
    _same_instance(got, jgot)
    assert tuple(stats) == tuple(jstats)
    # chunks with v < u are oriented as make_instance orients them
    flipped, _ = tg.make_instance_streamed(_chunks(v, u, c, 100), 156,
                                           pad_edges=700, pad_nodes=160,
                                           device=CPU)
    _same_instance(flipped[:4], inst[:4])
    assert flipped.num_nodes == 160 and int(flipped.node_valid.sum()) == 156


def test_make_instance_streamed_validates():
    ok = (np.array([0, 1]), np.array([1, 2]), np.array([1.0, -1.0]))
    with pytest.raises(ValueError, match="exceed pad_edges"):
        tg.make_instance_streamed([ok, ok], 3, pad_edges=3, device=CPU)
    with pytest.raises(ValueError, match="node ids"):
        tg.make_instance_streamed([ok], 2, pad_edges=4, device=CPU)
    with pytest.raises(ValueError, match="self-loops"):
        tg.make_instance_streamed([([1], [1], [2.0])], 3, pad_edges=4,
                                  device=CPU)
    with pytest.raises(ValueError, match="equal"):
        tg.make_instance_streamed([([0, 1], [1], [2.0])], 3, pad_edges=4,
                                  device=CPU)
    # without a process group state_shards clamps to one shard: the one
    # range is the whole instance
    inst, stats = tg.make_instance_streamed([ok], 3, pad_edges=4,
                                            state_shards=2, device=CPU)
    assert type(inst) is tg.MulticutInstance
    _same_instance(inst, tg.make_instance(*ok, 3, pad_edges=4, device=CPU))
    assert stats.peak_host_elems == 4 + 2


def test_round_up_edges_and_networkx():
    for args in [(1,), (16,), (17,), (100, 3), (100, 4, 16), (0,),
                 (1000, 6, 8)]:
        assert tg.round_up_edges(*args) == jg.round_up_edges(*args), args
    nx = pytest.importorskip("networkx")
    inst = tg.random_instance(12, 0.4, seed=1, pad_edges=64, device=CPU)
    g = tg.to_networkx(inst)
    jgraph = jg.to_networkx(jg.random_instance(12, 0.4, seed=1,
                                               pad_edges=64))
    assert isinstance(g, nx.Graph)
    assert sorted(g.nodes) == sorted(jgraph.nodes)
    assert sorted(g.edges(data="weight")) == \
        sorted(jgraph.edges(data="weight"))
