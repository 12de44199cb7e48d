"""The port's round modules against the JAX package's, one round at a time:
separation (triangles and chord slots exact), message passing
(reparametrised costs and lower bound to a stated tolerance) and
contraction (sets, mapping and the maintained CSR exact, the CSR also equal
to a fresh ``build_csr``)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.core import contraction as jc  # noqa: E402
from repro.core import cycles as jcy  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core import message_passing as jmp  # noqa: E402
from repro_torch.convert import instance_from_numpy  # noqa: E402
from repro_torch.core import contraction as tc  # noqa: E402
from repro_torch.core import cycles as tcy  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import message_passing as tmp  # noqa: E402

# Float tolerance of MP outputs: both packages sum each edge's triangle
# contributions in triangle order, but XLA's jitted CPU code fuses and
# rounds some intermediates differently from torch's eager ops, and the
# lower bound's global sums are reduced in another order — a few float32
# ulps apart (the reparametrised costs are not bitwise equal).
RTOL, ATOL = 1e-5, 1e-5

INSTANCES = {
    "grid": lambda: jg.grid_instance(16, 18, seed=7, pad_edges=1300),
    "cluster": lambda: jg.cluster_instance(70, seed=3, pad_edges=1700,
                                           pad_nodes=80),
}


def _pair(name):
    ji = INSTANCES[name]()
    return ji, instance_from_numpy(*[np.asarray(x) for x in ji],
                                   device="cpu")


def _eq(t, j):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


@functools.lru_cache(maxsize=None)
def _j_separate(short, chunk):
    return jax.jit(lambda inst: jcy.separate(
        inst, max_neg=64, max_tri_per_edge=4, with_cycles45=True,
        graph_impl="sparse", sparse_row_cap=128, sparse_row_cap_short=short,
        separation_chunk=chunk))


def _t_separate(ti, short, chunk):
    return tcy.separate(ti, max_neg=64, max_tri_per_edge=4,
                        with_cycles45=True, graph_impl="sparse",
                        sparse_row_cap=128, sparse_row_cap_short=short,
                        separation_chunk=chunk)


@pytest.mark.parametrize("name", sorted(INSTANCES))
@pytest.mark.parametrize("short,chunk", [(16, 0), (4, 24)])
def test_separation_exact(name, short, chunk):
    """Triangles and chord slots exact; (4, 24) runs the long degree
    bucket in streamed chunks."""
    ji, ti = _pair(name)
    js = _j_separate(short, chunk)(ji)
    ts = _t_separate(ti, short, chunk)
    _eq(ts.triangles.edges, js.triangles.edges)
    _eq(ts.triangles.valid, js.triangles.valid)
    assert bool(ts.triangles.valid.any())
    for t, j in zip(ts.instance, js.instance):      # chords in free slots
        _eq(t, j)
    assert int(ts.instance.edge_valid.sum()) > int(ti.edge_valid.sum())


def test_repulsive_selection_tie_order():
    """Non-candidates tie at -inf; the lowest indices come first, as
    jax.lax.top_k keeps them."""
    ji, ti = _pair("grid")
    for k in (8, 700):
        ji_idx, jok = jcy.select_repulsive_edges(ji, k)
        t_idx, tok = tcy.select_repulsive_edges(ti, k)
        _eq(t_idx, ji_idx)
        _eq(tok, jok)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_round_mp_then_contraction(name):
    ji, ti = _pair(name)
    js = _j_separate(16, 0)(ji)
    ts = _t_separate(ti, 16, 0)
    jstate, jc_rep, jlb = jmp.run_message_passing(
        js.instance.cost, js.instance.edge_valid,
        jmp.init_mp(js.triangles), 5)
    tstate, tc_rep, tlb = tmp.run_message_passing(
        ts.instance.cost, ts.instance.edge_valid,
        tmp.init_mp(ts.triangles), 5)
    np.testing.assert_allclose(tc_rep.numpy(), np.asarray(jc_rep),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tstate.t_cost.numpy(),
                               np.asarray(jstate.t_cost),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tlb), float(jlb), rtol=RTOL,
                               atol=ATOL)
    _eq(tmp.edge_degree(tstate, ti.num_edges),
        jmp.edge_degree(jstate, ti.num_edges))

    # contraction on the reference's own reparametrised costs, so the two
    # sides decide on identical inputs
    j3 = js.instance._replace(cost=jc_rep)
    t3 = ts.instance._replace(cost=torch.from_numpy(np.array(jc_rep)))
    jS = jc.choose_contraction_set(j3)
    tS = tc.choose_contraction_set(t3)
    _eq(tS, jS)
    _eq(tc.maximum_matching(t3), jc.maximum_matching(j3))
    _eq(tc.spanning_forest_contraction(t3),
        jc.spanning_forest_contraction(j3))
    _eq(tc.connected_components(t3.u, t3.v, tS & t3.edge_valid,
                                t3.num_nodes),
        jc.connected_components(j3.u, j3.v, jS & j3.edge_valid,
                                j3.num_nodes))
    jres, jcsr = jc.contract_csr(j3, jS)
    tres, tcsr = tc.contract_csr(t3, tS)
    for t, j in zip(tres.instance, jres.instance):
        _eq(t, j)                       # merged costs: same order, same bits
    for f in ("mapping", "n_new", "n_contracted"):
        _eq(getattr(tres, f), getattr(jres, f))
    np.testing.assert_allclose(float(tres.self_loop_gain),
                               float(jres.self_loop_gain), rtol=RTOL,
                               atol=ATOL)
    for t, j in zip(tcsr, jcsr):
        _eq(t, j)
    for t, f in zip(tcsr, tg.csr_from_instance(tres.instance)):
        assert torch.equal(t.long(), f.long())
    assert int(tres.n_contracted) > 0
