"""The fused message-passing phase on compact triangle-edge ids
(``kernels/triangle_mp``: ``mp_phase_ref``, the plain version of the
``triangle_mp_phase`` kernel, and its wrapper ``mp_phase``) against the
per-edge ``core.message_passing.run_message_passing`` — bit for bit — and
against the JAX package's message passing; plus the solver's routes.

On the CPU: ``PYTHONPATH=src python -m pytest -q tests/test_torch_mp.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import cycles as jcy  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core import message_passing as jmp  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.convert import instance_from_numpy, result_to_numpy  # noqa: E402,E501
from repro_torch.core import cycles as tcy  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import message_passing as tmp  # noqa: E402
from repro_torch.kernels.triangle_mp import ops as mp_ops  # noqa: E402
from repro_torch.kernels.triangle_mp.ref import mp_phase_ref, mp_plan  # noqa: E402,E501

ITERS = 5
# JAX's jitted run_message_passing fuses and rounds some intermediates
# otherwise than torch's eager ops, and reduces the bound's sums in
# another order: a few float32 ulps (tests/test_torch_modules.py)
RTOL, ATOL = 1e-5, 1e-5

# one padded shape for the three generators, so each side compiles once
PAD = dict(pad_nodes=576, pad_edges=3600)
INSTANCES = {
    "grid": lambda: jg.grid_instance(24, 24, seed=0, **PAD),
    "random": lambda: jg.random_instance(300, 0.02, seed=1, **PAD),
    "cluster": lambda: jg.cluster_instance(120, seed=2, **PAD),
}


def _round0(name):
    """The port's round-0 separation (5-cycles on, sparse path) of one
    generator instance: (cost, edge_valid, tri, tri_valid)."""
    ji = INSTANCES[name]()
    ti = instance_from_numpy(*[np.asarray(x) for x in ji], device="cpu")
    sep = tcy.separate(ti, max_neg=64, max_tri_per_edge=4,
                       with_cycles45=True, graph_impl="sparse")
    assert bool(sep.triangles.valid.any())
    return (sep.instance.cost, sep.instance.edge_valid,
            sep.triangles.edges, sep.triangles.valid)


def _synthetic(T, E, n_valid, share, seed, neg_zero=True):
    """Triangles over E edges from a numpy seed: ``n_valid`` valid rows
    spread over T (invalid rows zeroed, in the middle too), their edge
    ids drawn from ``3 * n_valid // share`` edges, so edges are shared by
    up to ~2·share triangles; one untouched edge costs −0.0, one edge in
    16 is invalid."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(E, size=max(3, 3 * n_valid // share), replace=False)
    tri = pool[rng.integers(0, pool.size, size=(T, 3))].astype(np.int32)
    valid = np.zeros(T, dtype=bool)
    valid[rng.choice(T, size=n_valid, replace=False)] = True
    tri[~valid] = 0
    cost = (rng.normal(size=E) * 3).astype(np.float32)
    untouched = np.setdiff1d(np.arange(E), tri[valid])
    if neg_zero:
        cost[untouched[0]] = -0.0
    ev = rng.random(E) >= 1 / 16
    return [torch.from_numpy(a) for a in (cost, ev, tri, valid)]


# (T, E, valid rows, pool share, seed): T not a multiple of 32 in all
SYNTHETIC = {
    "shared by up to 8": (301, 400, 200, 4, 0),
    "invalid rows in the middle": (999, 5000, 333, 1, 1),
    "no valid triangle": (77, 300, 0, 1, 2),
    "all valid, one shared edge": (5, 20, 5, 15, 3),
}


def _per_edge(cost, ev, tri, valid, iters=ITERS):
    state = tmp.init_mp(tcy.Triangles(edges=tri, valid=valid))
    state, c_rep, lb = tmp.run_message_passing(cost, ev, state, iters)
    return state.t_cost, c_rep, lb


def _assert_bitwise(got, want):
    for g, w, what in zip(got, want, ("t_cost", "c_rep", "lb")):
        assert g.shape == w.shape, what
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), what


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_phase_ref_equals_per_edge_on_round0(name):
    args = _round0(name)
    _assert_bitwise(mp_phase_ref(*args, ITERS), _per_edge(*args))


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
@pytest.mark.parametrize("iters", [0, 1, ITERS])
def test_phase_ref_equals_per_edge_synthetic(case, iters):
    T, E, n_valid, share, seed = SYNTHETIC[case]
    args = _synthetic(T, E, n_valid, share, seed)
    got = mp_phase_ref(*args, iters)
    _assert_bitwise(got, _per_edge(*args, iters))
    cost, _, tri, valid = args
    if case == "shared by up to 8":
        deg = np.bincount(tri[valid].numpy().ravel(), minlength=E)
        assert deg.max() >= 8
    neg = torch.nonzero(cost.view(torch.int32) == -2**31).ravel()
    assert neg.numel() == 1 and got[1][neg].view(torch.int32) == 0  # +0.0
    if n_valid == 0:
        assert not bool(got[0].any())


def test_plan_is_compact():
    """The plan relabels the valid triangles' distinct edges to [0, U):
    each segment's entries are its edge's valid slots in flat order, and
    its length is the edge's degree."""
    cost, _, tri, valid = _synthetic(*SYNTHETIC["invalid rows in the "
                                                 "middle"])
    plan = mp_plan(cost, tri, valid)
    flat = tri.reshape(-1).long()
    U = int((plan.length > 0).sum())
    assert U == len(set(tri[valid].reshape(-1).tolist()))
    assert bool((plan.length[U:] == 0).all())
    for s in range(U):
        st, n = int(plan.start[s]), int(plan.length[s])
        ent = plan.entries[st:st + n].long()
        assert bool((flat[ent] == plan.edge[s]).all())
        assert bool((ent[1:] > ent[:-1]).all())
        assert bool(valid[ent // 3].all())
        assert float(plan.cost_at[s]) == float(cost[plan.edge[s]])
    comp = plan.comp.reshape(-1).long()
    vslot = valid[:, None].expand(-1, 3).reshape(-1)
    assert torch.equal(plan.edge[comp[vslot]], flat[vslot])


@pytest.fixture(scope="module")
def quickstart_round0():
    """Quickstart's round-0 triangles on the dense path (T = 12 288)."""
    ti = instance_from_numpy(*[np.asarray(x) for x in jg.random_instance(
        n=200, p=0.08, seed=0, pad_edges=4096, pad_nodes=256)],
        device="cpu")
    sep = tcy.separate(ti, max_neg=1024, max_tri_per_edge=8,
                       with_cycles45=True, graph_impl="dense")
    return (sep.instance.cost, sep.instance.edge_valid,
            sep.triangles.edges, sep.triangles.valid)


def _to_jax(cost, ev, tri, valid):
    state = jmp.init_mp(jcy.Triangles(edges=jnp.asarray(tri.numpy()),
                                      valid=jnp.asarray(valid.numpy())))
    return jnp.asarray(cost.numpy()), jnp.asarray(ev.numpy()), state


@pytest.mark.parametrize("src", ["grid", "quickstart"])
def test_phase_ref_against_jax(src, quickstart_round0):
    """Against the JAX package: within RTOL of its jitted
    ``run_message_passing``, and the bits of its message passing run op
    by op (t_cost and c_rep; the bound's sums are reduced in another
    order, so it is held within RTOL)."""
    args = _round0(src) if src == "grid" else quickstart_round0
    iters = ITERS if src == "grid" else 10
    t_cost, c_rep, lb = mp_phase_ref(*args, iters)
    cost, ev, state = _to_jax(*args)
    jstate, jc_rep, jlb = jmp.run_message_passing(cost, ev, state, iters)
    np.testing.assert_allclose(c_rep.numpy(), np.asarray(jc_rep),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_cost.numpy(), np.asarray(jstate.t_cost),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(lb), float(jlb), rtol=RTOL, atol=ATOL)
    st = state
    for _ in range(iters):
        st = jmp.triangles_to_edges(jmp.edges_to_triangles(st, cost))
    np.testing.assert_array_equal(t_cost.numpy(), np.asarray(st.t_cost))
    np.testing.assert_array_equal(
        c_rep.numpy(), np.asarray(jmp.reparametrized_costs(cost, st)))
    np.testing.assert_allclose(float(lb),
                               float(jmp.lower_bound(cost, ev, st)),
                               rtol=RTOL, atol=ATOL)


def test_phase_wrapper_on_cpu_routes_to_plain():
    """On CPU tensors ``mp_phase`` runs the plain version: the same bits,
    no launch counted, the call's T counted in ``shapes``."""
    args = _synthetic(*SYNTHETIC["shared by up to 8"])
    before, calls = mp_ops.launches, mp_ops.shapes[301]
    _assert_bitwise(mp_ops.mp_phase(*args, ITERS),
                    mp_phase_ref(*args, ITERS))
    assert mp_ops.launches == before
    assert mp_ops.shapes[301] == calls + 1


@pytest.mark.parametrize("bad", ["cost float64", "tri int64", "tri (T, 2)",
                                 "edge_valid int", "tri_valid length",
                                 "iters", "device"])
def test_phase_wrapper_raises(bad):
    cost, ev, tri, valid = _synthetic(*SYNTHETIC["shared by up to 8"])
    iters = ITERS
    if bad == "cost float64":
        cost = cost.double()
    elif bad == "tri int64":
        tri = tri.long()
    elif bad == "tri (T, 2)":
        tri = tri[:, :2]
    elif bad == "edge_valid int":
        ev = ev.int()
    elif bad == "tri_valid length":
        valid = valid[:-1]
    elif bad == "iters":
        iters = -1
    else:
        cost = cost.to("meta")
    with pytest.raises(ValueError, match="mp_phase"):
        mp_ops.mp_phase(cost, ev, tri, valid, iters)


# one sparse (above 256 padded nodes) and one dense (below) instance
SOLVE_INSTANCES = {
    "sparse grid 24x24": lambda: tg.grid_instance(24, 24, seed=4,
                                                  device="cpu"),
    "dense random 200": lambda: tg.random_instance(
        n=200, p=0.08, seed=0, pad_edges=4096, pad_nodes=256,
        device="cpu"),
}


@pytest.mark.parametrize("mode", ["pd", "d"])
@pytest.mark.parametrize("name", sorted(SOLVE_INSTANCES))
def test_solve_default_route_equals_reference(name, mode):
    """The default backend's solve (the fused phase; its plain version on
    the CPU) equals ``backend="reference"`` (the per-edge layout)
    exactly."""
    inst = SOLVE_INSTANCES[name]()
    a = result_to_numpy(tapi.solve(inst, mode=mode, device="cpu"))
    b = result_to_numpy(tapi.solve(inst, mode=mode, backend="reference",
                                   device="cpu"))
    for f, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert np.isfinite(a.lower_bound)
