"""The port's ``core/dist.py`` collectives and the sharded halves of
contraction and message passing against the JAX package, and the block
decomposition.

In-process, JAX runs its sharded functions under ``shard_map`` over
``state_mesh(1)`` (one CPU device) and the port without a process group:
``tree_sum``/``blocked_sum`` bitwise; ``combine_node_best``,
``gather_edge_field``, the sharded CC and contraction set exactly; the
sharded contraction's integers exactly and its merged costs bitwise equal
to the port's replicated ``_contract_core``; the sharded MP's costs and
bound within rtol 1e-5 (the reference's compiled MP differs by ulps);
``partition_instance``/``merge_blocks_quotient`` exactly.

Over gloo, one spawned run of 4 ranks (``repro_torch.launch.ranks``)
holds the collectives and the sharded functions at S = 2 and 4 bit for
bit against S = 1, and the distributed PD round on 4 ranks of 2 blocks
against the one-rank round of 8 blocks.
"""
import inspect
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.core import contraction as jc, dist as jd, graph as jg  # noqa: E402,E501
from repro.core import message_passing as jmp  # noqa: E402
from repro.core.solver import SolverConfig as JConfig  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import contraction as tc, dist as td  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core.message_passing import run_message_passing_sharded, \
    mp_phase_per_edge  # noqa: E402
from repro_torch.core.solver import SolverConfig  # noqa: E402
from repro_torch.kernels.triangle_mp.ref import mp_phase_ref  # noqa: E402
from repro_torch.launch.ranks import spawn  # noqa: E402

CPU = "cpu"
RTOL = 1e-5
MESH = jd.state_mesh(1)
E_ = P(jd.STATE_AXIS)


def _smap(fn, in_specs, out_specs):
    """``fn`` under a jitted shard_map over the one-device state mesh."""
    return jax.jit(shard_map(fn, mesh=MESH, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


def _cases():
    """Inputs of the checks, from seeds, with the port only (this source
    also runs in each spawned rank): a random instance, a contraction
    mask, the triangles of one 3-cycle separation, float and id vectors,
    and an instance whose contraction merges three edges of both
    orientations into one pair."""
    import numpy as np
    from repro_torch.core import graph as tg
    from repro_torch.core.cycles import separate
    inst = tg.random_instance(60, 0.15, seed=3, pad_edges=1024,
                              pad_nodes=64, device="cpu")
    rng = np.random.default_rng(0)
    S = torch.from_numpy(rng.random(1024) < 0.3) & inst.edge_valid
    sep = separate(inst, max_neg=64, max_tri_per_edge=4,
                   with_cycles45=False, graph_impl="sparse")
    x = torch.from_numpy(rng.standard_normal(1024).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 1024, 300).astype(np.int32))
    # edges 0:(0,1) 1e8, 1:(0,4) and 2:(1,3) contracted, 3:(3,4) -1e8 (its
    # endpoints' clusters come in the other order), 4:(0,3) 1.0
    u = np.zeros(16, np.int32)
    v = np.zeros(16, np.int32)
    c = np.zeros(16, np.float32)
    u[:5], v[:5] = [0, 0, 1, 3, 0], [1, 4, 3, 4, 3]
    c[:5] = [1e8, 5.0, 5.0, -1e8, 1.0]
    mixed = tg.MulticutInstance(
        torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(c),
        torch.arange(16) < 5, torch.ones(8, dtype=torch.bool))
    mixed_S = torch.zeros(16, dtype=torch.bool)
    mixed_S[1:3] = True
    return dict(inst=inst, S=S, tri=sep.triangles.edges,
                tri_valid=sep.triangles.valid, x=x, ids=ids, mixed=mixed,
                mixed_S=mixed_S)


C = _cases()


def _j(t):
    return jnp.asarray(t.numpy())


def _ji(inst):
    return jg.MulticutInstance(*(_j(t) for t in inst))


# ---------------------------------------------------------------------------
# In-process, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 3, 5, 16, 17, 1000, 4096])
def test_tree_sum_bitwise(width):
    x = np.random.default_rng(width).standard_normal((3, width)) \
        .astype(np.float32) * 1e3
    got = td.tree_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jd.tree_sum(x)))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jd.tree_sum)(x)))


def test_blocked_sum_bitwise():
    x = C["x"]
    want = _smap(lambda a: jd.blocked_sum(a, 1)[None], (E_,), P())(_j(x))
    got = td.blocked_sum(x, 1, None)
    assert got.numpy().tobytes() == np.asarray(want)[0].tobytes()


def test_gather_edge_field_and_combine_node_best():
    x, ids = C["x"], C["ids"]
    want = _smap(lambda a, i: jd.gather_edge_field(a, i), (E_, P()),
                 P())(_j(x), _j(ids))
    got = td.gather_edge_field(x, ids, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  x.numpy()[np.clip(ids.numpy(), 0, None)])
    rng = np.random.default_rng(4)
    val = rng.integers(0, 3, 50).astype(np.float32)
    key = rng.permutation(50).astype(np.int32)
    pay = rng.integers(-1, 99, 50).astype(np.int32)
    want = _smap(lambda a, b, c: jd.combine_node_best(a, b, c),
                 (P(), P(), P()), (P(), P(), P()))(val, key, pay)
    got = td.combine_node_best(*(torch.from_numpy(a)
                                 for a in (val, key, pay)), None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_collectives_without_a_group_are_identities():
    x = C["x"]
    assert td.all_gather(x, None).shape == (1, 1024)
    for f in (td.all_min, td.all_max):
        assert torch.equal(f(x, None), x)
    assert torch.equal(td.all_sum_int(C["ids"], None), C["ids"])
    with pytest.raises(TypeError, match="blocked_sum"):
        td.all_sum_int(x, None)
    assert td.group_size(None) == 1 and td.edge_range_start(256, None) == 0
    assert td.state_group(1) is None
    with pytest.raises(ValueError, match="process group"):
        td.state_group(2)
    assert [td.resolve_state_shards(s) for s in (None, 0, 1, 3, 4)] == \
        [1] * 5


def _one_rank_env(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_RANK", "0")
    monkeypatch.setenv("REPRO_WORLD", "1")
    monkeypatch.setenv("REPRO_STORE", str(tmp_path / "store"))


def test_process_group_frees_every_group(monkeypatch, tmp_path):
    """A one-rank gloo group through ``process_group``: a collective over
    the state group and an op under the roofline's work counter (its
    first use imports ``torch._dynamo``, which imports
    ``torch.distributed.nn.functional``, whose default arguments bind the
    default group) leave no group object alive after the block."""
    import torch.distributed as dist
    from repro_torch.launch.ranks import process_group
    from repro_torch.roofline.solver import WorkCounter
    _one_rank_env(monkeypatch, tmp_path)
    with process_group("gloo") as (rank, world):
        assert (rank, world) == (0, 1)
        got = td.all_gather(torch.arange(3), td.state_group(1))
        with WorkCounter():
            torch.zeros(3) + 1
    assert not dist.is_initialized()
    np.testing.assert_array_equal(got.numpy(), [[0, 1, 2]])


def test_process_group_refuses_a_surviving_group(monkeypatch, tmp_path):
    """A group handle kept past the block would keep the group's worker
    threads running into interpreter exit: ``process_group`` raises
    after destroying the group."""
    import torch.distributed as dist
    from repro_torch.launch.ranks import process_group
    _one_rank_env(monkeypatch, tmp_path)
    kept = []
    with pytest.raises(RuntimeError, match="1 of 1 process group"):
        with process_group("gloo"):
            kept.append(dist.group.WORLD)
    assert not dist.is_initialized()
    kept.clear()


def test_cc_and_contraction_set_sharded():
    """The sharded CC, matching/forest switch (plain and with
    contract_frac) against the reference's, exactly, and against the
    port's replicated functions."""
    inst, S = C["inst"], C["S"]
    ji = _ji(inst)
    want = _smap(lambda u, v, m: jc.connected_components_sharded(
        u, v, m, 64, jd.STATE_AXIS), (E_, E_, E_), P())(ji.u, ji.v, _j(S))
    got = tc.connected_components_sharded(inst.u, inst.v, S, 64, None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tc.connected_components(inst.u, inst.v, S, 64))
    for frac in (0.0, 0.5):
        want = _smap(lambda u, v, c, ev, nv: jc.choose_contraction_set_sharded(
            u, v, c, ev, nv, 3, 4, 0.1, frac, 1, jd.STATE_AXIS),
            (E_, E_, E_, E_, P()), E_)(*ji)
        got = tc.choose_contraction_set_sharded(
            inst.u, inst.v, inst.cost, inst.edge_valid, inst.node_valid, 3,
            4, 0.1, frac, 1, None)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        rep = tc.choose_contraction_set(inst, 3, 4, 0.1, frac)
        assert torch.equal(got, rep)


def test_contract_sharded():
    """Integer outputs equal the reference's contract_sharded; the merged
    costs equal the port's replicated contraction bit for bit."""
    inst, S = C["inst"], C["S"]
    ji = _ji(inst)

    def jfn(u, v, c, ev, nv, s):
        r = jc.contract_sharded(u, v, c, ev, nv, s, 1, jd.STATE_AXIS)
        return (r.u2, r.v2, r.c2, r.ev2, r.node_valid, r.mapping, r.n_new,
                r.n_contracted, r.csr.row_ptr, r.csr.col, r.csr.edge_id)
    want = _smap(jfn, (E_,) * 4 + (P(), E_),
                 (E_,) * 4 + (P(),) * 4 + (E_,) * 3)(*ji, _j(S))
    got = tc.contract_sharded(*inst, S, 1, None)
    got = (got.u2, got.v2, got.c2, got.ev2, got.node_valid, got.mapping,
           got.n_new, got.n_contracted, *got.csr)
    for k, g, w in zip(("u2", "v2", "c2", "ev2", "node_valid", "mapping",
                        "n_new", "n_contracted", "row_ptr", "col",
                        "edge_id"), got, want):
        if k == "c2":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=k)
    rep, csr = tc._contract_core(inst, S)
    for g, w in zip(got[:4], rep.instance[:4]):
        assert torch.equal(g, w)
    for g, w in zip(got[8:], csr):
        assert torch.equal(g.to(w.dtype), w)


def test_contract_sharded_keeps_the_replicated_sum_order():
    """Three edges merge into one pair, two with (fu < fv) and the middle
    id with (fu > fv): summed by ascending edge id, as the replicated
    sort leaves them, the pair's cost is (1e8 - 1e8) + 1 = 1. The
    reference's sharded exchange adds the (fu < fv) entries first and
    gets (1e8 + 1) - 1e8 = 0, unlike its own replicated contraction; the
    port keeps the replicated order."""
    inst, S = C["mixed"], C["mixed_S"]
    got = tc.contract_sharded(*inst, S, 1, None)
    rep = tc._contract_core(inst, S)[0].instance
    jrep = jc._contract_core(_ji(inst), _j(S))[0].instance
    assert float(got.c2[0]) == float(rep.cost[0]) == \
        float(jrep.cost[0]) == 1.0
    jsh = _smap(lambda u, v, c, ev, nv, s: jc.contract_sharded(
        u, v, c, ev, nv, s, 1, jd.STATE_AXIS).c2, (E_,) * 4 + (P(), E_),
        E_)(*_ji(inst), _j(S))
    assert float(jsh[0]) == 0.0


@pytest.mark.parametrize("mp", ["phase", "per_edge"])
def test_run_message_passing_sharded(mp):
    """c_rep and the bound against the reference within rtol 1e-5; c_rep
    bitwise equal to the replicated phase on the full cost vector, with
    either phase function on the compact ids."""
    inst, tri, tv = C["inst"], C["tri"], C["tri_valid"]
    jw = _smap(lambda c, ev, t, tvv: jmp.run_message_passing_sharded(
        c, ev, t, tvv, 5, 1), (E_, E_, P(), P()), (E_, P()))(
        _j(inst.cost), _j(inst.edge_valid), _j(tri), _j(tv))
    fn = mp_phase_ref if mp == "phase" else mp_phase_per_edge
    c_rep, lb = run_message_passing_sharded(inst.cost, inst.edge_valid, tri,
                                            tv, 5, 1, None, mp=fn)
    np.testing.assert_allclose(c_rep.numpy(), np.asarray(jw[0]), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(float(lb), float(jw[1]), rtol=RTOL)
    _, rep, rep_lb = mp_phase_ref(inst.cost, inst.edge_valid, tri, tv, 5)
    assert torch.equal(c_rep, rep)
    np.testing.assert_allclose(float(lb), float(rep_lb), rtol=RTOL)


def test_partition_and_quotient():
    ji = jg.random_instance(400, 0.05, seed=3, pad_edges=8192,
                            pad_nodes=512)
    ti = tg.random_instance(400, 0.05, seed=3, pad_edges=8192,
                            pad_nodes=512, device=CPU)
    want = jd.partition_instance(ji, 8, 64, 1024)
    got = td.partition_instance(ti, 8, 64, 1024)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    labels = np.random.default_rng(1).integers(0, 20, (8, 64))
    args = (want["boundary_u"], want["boundary_v"], want["boundary_cost"],
            64, 4096)
    jq, jgl = jd.merge_blocks_quotient(labels, *args)
    tq, tgl = td.merge_blocks_quotient(labels, *args, device=CPU)
    np.testing.assert_array_equal(tgl, jgl)
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dist_pd_round_one_block_against_reference():
    """One block on one rank against the reference's shard_mapped round
    on a one-device mesh: the contracted block and mapping exactly, its
    costs and the global bound within rtol 1e-5."""
    ji = jg.random_instance(400, 0.05, seed=3, pad_edges=8192,
                            pad_nodes=512)
    parts = jd.partition_instance(ji, 1, 512, 8192)
    keys = ("u", "v", "cost", "edge_valid", "node_valid", "boundary_cost")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    want = jax.jit(jd.make_dist_pd_round(mesh, mp_iters=3, max_neg=64))(
        *(jnp.asarray(parts[k]) for k in keys))
    got = td.make_dist_pd_round(None, mp_iters=3, max_neg=64,
                                backend="reference")(
        *(torch.from_numpy(parts[k]) for k in keys))
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (2, 6):
            np.testing.assert_allclose(g.numpy().reshape(-1),
                                       np.asarray(w).reshape(-1), rtol=RTOL,
                                       atol=RTOL)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Four ranks over gloo
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import os
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.ranks import process_group
    from repro_torch.core import contraction as tc, dist as td
    from repro_torch.core import graph as tg
    from repro_torch.core.message_passing import \\
        run_message_passing_sharded
    from repro_torch.kernels.triangle_mp.ref import mp_phase_ref
    OUT = %(out)r
""") + textwrap.dedent(inspect.getsource(_cases)) + textwrap.dedent("""
    C = _cases()
    out = {}


    def work(rank):
        W = dist.group.WORLD
        g = torch.arange(3, dtype=torch.int32) + 10 * rank
        out["gather"] = td.all_gather(g, W).numpy()
        out["gather_bool"] = td.all_gather(g %% 2 == 0, W).numpy()
        out["min"] = td.all_min(g, W).numpy()
        out["max"] = td.all_max(g.float(), W).numpy()
        out["sum"] = td.all_sum_int(g.long(), W).numpy()
        for S in (1, 2, 4):
            grp = td.state_group(S)
            if rank >= S:
                continue

            def rng_(t):
                n = t.shape[0] // S
                return t[rank * n:(rank + 1) * n]
            inst = C["inst"]
            loc = [rng_(t) for t in inst[:4]]
            out[f"S{S}/blocked"] = td.blocked_sum(rng_(C["x"]), S,
                                                  grp).numpy()
            out[f"S{S}/gather"] = td.gather_edge_field(rng_(C["x"]),
                                                       C["ids"], grp).numpy()
            sel = tc.choose_contraction_set_sharded(
                *loc, inst.node_valid, 3, 4, 0.1, 0.0, S, grp)
            out[f"S{S}/choose"] = sel.numpy()
            con = tc.contract_sharded(*loc, inst.node_valid, rng_(C["S"]),
                                      S, grp)
            for k, x in con._asdict().items():
                if k != "csr":
                    out[f"S{S}/contract/{k}"] = x.numpy()
            c_rep, lb = run_message_passing_sharded(
                loc[2], loc[3], C["tri"], C["tri_valid"], 5, S, grp,
                mp=mp_phase_ref)
            out[f"S{S}/mp/c_rep"], out[f"S{S}/mp/lb"] = c_rep.numpy(), \\
                lb.numpy()
            if S <= 2:
                mixed = [rng_(t) for t in C["mixed"][:4]]
                out[f"S{S}/mixed_c2"] = tc.contract_sharded(
                    *mixed, C["mixed"].node_valid, rng_(C["mixed_S"]), S,
                    grp).c2.numpy()
        big = tg.random_instance(400, 0.05, seed=3, pad_edges=8192,
                                 pad_nodes=512, device="cpu")
        parts = td.partition_instance(big, 8, 64, 1024)
        keys = ("u", "v", "cost", "edge_valid", "node_valid",
                "boundary_cost")
        res = td.make_dist_pd_round(W, mp_iters=3, max_neg=64)(
            *(torch.from_numpy(parts[k]) for k in keys))
        for i, x in enumerate(res):
            out[f"dist_pd/{i}"] = x.numpy()


    with process_group("gloo") as (rank, world):
        work(rank)
    out["group_destroyed"] = np.array(not dist.is_initialized())
    np.savez(os.path.join(OUT, f"rank{rank}.npz"), **out)
""")


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo4")
    spawn(WORKER % dict(out=str(d)), world=4, store=d / "store",
          timeout=300)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def test_gloo_collectives(gloo_runs):
    """all_gather in rank order (bool over the wire as uint8), exact
    min/max, integer sums, over 4 ranks; every rank destroyed its group
    before it wrote its results and exited."""
    g = np.arange(3, dtype=np.int32) + 10 * np.arange(4)[:, None]
    for run in gloo_runs:
        assert bool(run["group_destroyed"])
        np.testing.assert_array_equal(run["gather"], g)
        np.testing.assert_array_equal(run["gather_bool"], g % 2 == 0)
        np.testing.assert_array_equal(run["min"], g.min(0))
        np.testing.assert_array_equal(run["max"], g.max(0))
        np.testing.assert_array_equal(run["sum"], g.sum(0))


def _concat(gloo_runs, S, key):
    return np.concatenate([gloo_runs[r][f"S{S}/{key}"] for r in range(S)])


@pytest.mark.parametrize("S", [1, 2, 4])
def test_gloo_sharded_primitives_invariant(gloo_runs, S):
    """At S = 1 (a gloo group of one), 2 and 4: blocked_sum and the halo
    gather the same bits on every rank as without a group; the contraction
    set, the contraction (merged costs included) and the MP costs, put
    together in rank order, equal the one-rank results bit for bit; the
    bound is the same bits."""
    inst, S_mask = C["inst"], C["S"]
    for r in range(S):
        run = gloo_runs[r]
        assert run[f"S{S}/blocked"].tobytes() == \
            td.blocked_sum(C["x"], 1, None).numpy().tobytes()
        np.testing.assert_array_equal(
            run[f"S{S}/gather"], td.gather_edge_field(C["x"], C["ids"],
                                                      None).numpy())
    np.testing.assert_array_equal(
        _concat(gloo_runs, S, "choose"),
        tc.choose_contraction_set(inst, 3, 4, 0.1, 0.0).numpy())
    one = tc.contract_sharded(*inst, S_mask, 1, None)
    for k, x in one._asdict().items():
        if k == "csr":
            continue
        if x.dim() and x.shape[0] == inst.num_edges:
            got = _concat(gloo_runs, S, f"contract/{k}")
        else:
            got = gloo_runs[S - 1][f"S{S}/contract/{k}"]
        np.testing.assert_array_equal(got, x.numpy(), err_msg=k)
    c_rep, lb = run_message_passing_sharded(
        inst.cost, inst.edge_valid, C["tri"], C["tri_valid"], 5, 1, None,
        mp=mp_phase_ref)
    np.testing.assert_array_equal(_concat(gloo_runs, S, "mp/c_rep"),
                                  c_rep.numpy())
    for r in range(S):
        assert gloo_runs[r][f"S{S}/mp/lb"].tobytes() == \
            lb.numpy().tobytes()
    if S <= 2:
        got = _concat(gloo_runs, S, "mixed_c2")
        assert got[0] == 1.0


def test_gloo_dist_pd_round(gloo_runs):
    """4 ranks of 2 blocks each: every rank returns the one-rank round of
    the 8 blocks bit for bit (the bound is a fixed-order sum), and the
    bound lies below the replicated solve's objective, as the reference's
    ``test_dist_pd_round_runs_and_lb_valid`` checks."""
    big = tg.random_instance(400, 0.05, seed=3, pad_edges=8192,
                             pad_nodes=512, device=CPU)
    parts = td.partition_instance(big, 8, 64, 1024)
    keys = ("u", "v", "cost", "edge_valid", "node_valid", "boundary_cost")
    one = td.make_dist_pd_round(None, mp_iters=3, max_neg=64)(
        *(torch.from_numpy(parts[k]) for k in keys))
    for run in gloo_runs:
        for i, x in enumerate(one):
            np.testing.assert_array_equal(run[f"dist_pd/{i}"], x.numpy())
    obj = api.solve(big, config=SolverConfig(max_neg=512), device=CPU)
    assert float(one[6]) <= float(obj.objective) + 1e-3
    q, _ = td.merge_blocks_quotient(one[5].numpy(), parts["boundary_u"],
                                    parts["boundary_v"],
                                    parts["boundary_cost"], 64, 4096,
                                    device=CPU)
    assert int(q.node_valid.sum()) > 0
    jobj = japi.solve(jg.random_instance(400, 0.05, seed=3, pad_edges=8192,
                                         pad_nodes=512), mode="pd",
                      config=JConfig(max_neg=512))
    np.testing.assert_allclose(float(obj.objective), float(jobj.objective),
                               rtol=RTOL)
