"""The dense separation data path of the port and the CSR splicing mode d
needs, against the JAX package on the same numpy-made inputs.

``tests/test_graph_impl.py``'s three instance families at its one padded
shape (32 nodes, 512 edge slots), so each reference function compiles once
per setting. Every output here is an integer or a boolean (adjacency,
triangles, chord slots, CSR arrays) and must be exactly equal. The solves
of every mode on both data paths are in ``tests/test_torch_modes.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import cycles as jcy  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch.convert import instance_from_numpy  # noqa: E402
from repro_torch.core import cycles as tcy  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

PAD_N, PAD_E = 32, 512
FAMILIES = {
    "random": lambda s: jg.random_instance(24, 0.3, seed=s, pad_edges=PAD_E,
                                           pad_nodes=PAD_N),
    "grid": lambda s: jg.grid_instance(5, 6, seed=s, pad_edges=PAD_E,
                                       pad_nodes=PAD_N),
    "cluster": lambda s: jg.cluster_instance(24, seed=s, pad_edges=PAD_E,
                                             pad_nodes=PAD_N),
}


@functools.lru_cache(maxsize=None)
def _j_separate(impl, with45, update_csr=False):
    """The reference's separation, jitted once per setting (every family
    shares one padded shape)."""
    return jax.jit(lambda inst: jcy.separate(
        inst, max_neg=64, max_tri_per_edge=4, with_cycles45=with45,
        graph_impl=impl, update_csr=update_csr))


def _pair(ji):
    return instance_from_numpy(*[np.asarray(x) for x in ji], device="cpu")


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j),
                                  err_msg=msg)


def _eq_instances(t, j):
    for f in ("u", "v", "cost", "edge_valid", "node_valid"):
        _eq(getattr(t, f), getattr(j, f), f)


# ---------------------------------------------------------------------------
# Dense separation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_build_adjacency_exact(family, seed):
    ji = FAMILIES[family](seed)
    ja, ta = jcy.build_adjacency(ji), tcy.build_adjacency(_pair(ji))
    assert ta.Apos.dtype == torch.bool and ta.eidx.dtype == torch.int32
    _eq(ta.Apos, ja.Apos)
    _eq(ta.eidx, ja.eidx)
    jd, td = jcy.build_dense(ji), tcy.build_dense(_pair(ji))
    np.testing.assert_allclose(td.A.numpy(), np.asarray(jd.A), rtol=0,
                               atol=0)


@pytest.mark.parametrize("with45", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dense_separation_exact(family, with45):
    """Triangles, valid flags and the chord-extended instance equal the
    reference's dense path, and the port's own sparse path. (The grid
    family has no triangles; 4/5-cycles are found in every family.)"""
    found = 0
    for seed in range(2):
        ji = FAMILIES[family](seed)
        ti = _pair(ji)
        kw = dict(max_neg=64, max_tri_per_edge=4, with_cycles45=with45)
        js = _j_separate("dense", with45)(ji)
        ts = tcy.separate(ti, graph_impl="dense", **kw)
        ss = tcy.separate(ti, graph_impl="sparse", **kw)
        for other in (js, ss):
            _eq(ts.triangles.edges, other.triangles.edges)
            _eq(ts.triangles.valid, other.triangles.valid)
            _eq_instances(ts.instance, other.instance)
        assert ts.csr is None
        found += int(ts.triangles.valid.sum())
    assert found > 0 or (family == "grid" and not with45)


def test_argmax_and_top_k_tie_order():
    """Ties: ``jnp.argmax`` and ``torch.argmax`` both return the first
    maximum, and ``_topk_lowest_index`` keeps ``jax.lax.top_k``'s
    lowest-index order over 0/1 rows, which ``torch.topk`` does not
    promise."""
    rng = np.random.default_rng(0)
    rows = (rng.random((64, 40)) < 0.3).astype(np.float32)
    rows[0] = 0.0                       # all tied at 0
    rows[1] = 1.0                       # all tied at 1
    score = np.where(rng.random((64, 16)) < 0.5, 2.0, 1.0) \
        .astype(np.float32)
    score[2] = -np.inf
    for x in (rows, score):
        np.testing.assert_array_equal(
            torch.argmax(torch.from_numpy(x), dim=1).numpy(),
            np.asarray(jnp.argmax(jnp.asarray(x), axis=1)))
    for k in (1, 4, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = tcy._topk_lowest_index(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# Splicing chords into a live CSR
# ---------------------------------------------------------------------------

def _random_patch(rng, inst, n_add):
    """A patch of the kind incremental solves and chord allocation make:
    drop some valid edges, add fresh (lo, hi) pairs into free slots (some
    rows masked off)."""
    ev = np.asarray(inst.edge_valid)
    E, N = ev.shape[0], int(np.asarray(inst.node_valid).sum())
    drop = ev & (rng.random(E) < 0.2)
    free = np.where(~ev)[0]
    present = {(int(a), int(b)) for a, b in
               zip(np.asarray(inst.u)[ev], np.asarray(inst.v)[ev])}
    adds = []
    while len(adds) < n_add:
        a, b = sorted(int(x) for x in rng.integers(0, N, 2))
        if a != b and (a, b) not in present:
            present.add((a, b))
            adds.append((a, b))
    add_u = np.array([a for a, _ in adds], np.int32)
    add_v = np.array([b for _, b in adds], np.int32)
    add_eid = free[:n_add].astype(np.int32)
    add_ok = rng.random(n_add) < 0.8
    return drop, add_u, add_v, add_eid, add_ok


@pytest.mark.parametrize("seed", range(4))
def test_splice_csr_exact(seed):
    """``splice_csr`` equals the reference's on random drops and adds, and
    equals a fresh ``build_csr`` of the patched instance."""
    rng = np.random.default_rng(seed)
    ji = FAMILIES[sorted(FAMILIES)[seed % 3]](seed)
    patch = _random_patch(rng, ji, 12)
    jcsr = jax.jit(jg.splice_csr)(jg.csr_from_instance(ji),
                                  *(jnp.asarray(a) for a in patch))
    ti = _pair(ji)
    tcsr = tg.splice_csr(tg.csr_from_instance(ti),
                         *(torch.from_numpy(np.asarray(a)) for a in patch))
    for t, j in zip(tcsr, jcsr):
        _eq(t, j)
    drop, add_u, add_v, add_eid, add_ok = patch
    u, v = np.asarray(ji.u).copy(), np.asarray(ji.v).copy()
    ev = np.asarray(ji.edge_valid) & ~drop
    u[add_eid[add_ok]], v[add_eid[add_ok]] = add_u[add_ok], add_v[add_ok]
    ev[add_eid[add_ok]] = True
    fresh = tg.build_csr(torch.from_numpy(u), torch.from_numpy(v),
                         torch.from_numpy(ev), ti.num_nodes)
    for t, f in zip(tcsr, fresh):
        assert torch.equal(t.long(), f.long())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_separate_update_csr(family):
    """Sparse ``separate(update_csr=True)`` returns the chord-spliced CSR:
    equal to the reference's and to a rebuild from the chorded instance."""
    ji = FAMILIES[family](0)
    ti = _pair(ji)
    js = _j_separate("sparse", True, update_csr=True)(ji)
    ts = tcy.separate(ti, max_neg=64, max_tri_per_edge=4, with_cycles45=True,
                      graph_impl="sparse", update_csr=True)
    assert int(ts.instance.edge_valid.sum()) > int(ti.edge_valid.sum())
    for t, j in zip(ts.csr, js.csr):
        _eq(t, j)
    for t, f in zip(ts.csr, tg.csr_from_instance(ts.instance)):
        assert torch.equal(t.long(), f.long())
