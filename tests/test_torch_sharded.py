"""The port's edge-range-sharded solve (``repro_torch.core.sharded``)
against the JAX package's ``solve_state_sharded`` and the port's own
replicated sparse solve.

In-process, without a process group, the state group is one rank (S = 1):
labels, rounds and histories equal the reference's and the replicated
path's; objective and bound are the reference's within rtol 1e-5 (they
are its blocked sums; its compiled MP differs by ulps). Over gloo, one
spawned run of 4 ranks (``repro_torch.launch.ranks``: ``python -c``
ranks importing only torch and the port, joined over a FileStore) solves
at S = 1 (a subgroup of one rank), 2 (ranks 2 and 3 receive the result by
broadcast) and 4: every result leaf is bit-identical across S and to the
in-process solve, and streamed ingest gives each rank its own range.
"""
import dataclasses
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core.solver import SolverConfig as JConfig  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import instance_from_numpy  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core.dist import resolve_state_shards  # noqa: E402
from repro_torch.core.sharded import validate_state_sharded  # noqa: E402
from repro_torch.core.solver import SolverConfig, solve_device  # noqa: E402
from repro_torch.launch.ranks import spawn  # noqa: E402

CPU = "cpu"
RTOL = 1e-5
# one padded shape for every family: the reference compiles once
PAD_NODES, PAD_EDGES = 64, 1024
FAMILIES = {
    "random": lambda m: m.random_instance(60, 0.15, seed=3,
                                          pad_edges=PAD_EDGES,
                                          pad_nodes=PAD_NODES),
    "grid": lambda m: m.grid_instance(8, 8, seed=1, pad_edges=PAD_EDGES,
                                      pad_nodes=PAD_NODES),
    "cluster": lambda m: m.cluster_instance(48, k=4, seed=2,
                                            pad_edges=PAD_EDGES,
                                            pad_nodes=PAD_NODES),
}
BASE = SolverConfig(graph_impl="sparse", first_round_cycles45=False)
SHARDED = dataclasses.replace(BASE, state_shards=1)
INT_ROWS = ("rounds", "n_cycles", "n_contracted", "n_clusters",
            "shard_edges", "shard_topk", "shard_halo")
STREAM_CHUNK = 23
PROF = dict(max_neg=64, mp_iters=3)      # the profiled round's config


def _inst(name):
    return FAMILIES[name](jg), instance_from_numpy(
        *[np.asarray(x) for x in FAMILIES[name](jg)], device=CPU)


def _np(tree) -> dict:
    return {k: x.numpy() for k, x in tree._asdict().items()}


@pytest.fixture(scope="module")
def port_runs():
    """In-process results (no process group, S = 1): sharded traced and
    untraced, and the replicated sparse solve."""
    out = {}
    for name in FAMILIES:
        inst = _inst(name)[1]
        out[name] = dict(
            sharded=_np(api.solve(inst, config=SHARDED, device=CPU)),
            replicated=_np(api.solve(inst, config=BASE, device=CPU)))
        r, tr = api.solve(inst, config=SHARDED, trace=True, device=CPU)
        out[name]["traced"], out[name]["trace"] = _np(r), _np(tr)
    return out


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_state_sharded_matches_reference(name, port_runs):
    """S = 1 against the reference's solve_state_sharded (shard_map over
    one device): labels, rounds, histories and the trace's integer rows
    exactly; objective, bound, the bound history and the trace's floats
    within rtol 1e-5."""
    ji = _inst(name)[0]
    jcfg = JConfig(graph_impl="sparse", first_round_cycles45=False,
                   state_shards=1)
    jr, jt = japi.solve(ji, mode="pd", config=jcfg, trace=True)
    t, tt = port_runs[name]["traced"], port_runs[name]["trace"]
    for k in ("labels", "rounds", "n_contracted", "n_clusters"):
        np.testing.assert_array_equal(t[k], np.asarray(getattr(jr, k)),
                                      err_msg=k)
    for k in INT_ROWS:
        np.testing.assert_array_equal(tt[k], np.asarray(getattr(jt, k)),
                                      err_msg=k)
    for k in ("objective", "lower_bound", "lb_history"):
        np.testing.assert_allclose(t[k], np.asarray(getattr(jr, k)),
                                   rtol=RTOL, err_msg=k)
    live = slice(0, int(t["rounds"]))
    for k in ("lower_bound", "objective", "mp_improvement"):
        np.testing.assert_allclose(tt[k][live], np.asarray(getattr(jt, k))
                                   [live], rtol=RTOL, atol=RTOL, err_msg=k)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_state_sharded_matches_replicated(name, port_runs):
    """S = 1 against the port's replicated sparse solve of the same config:
    labels, rounds and histories equal, the scalars within rtol 1e-5;
    traced = untraced bit for bit, with shard rows of width 1."""
    s, r = port_runs[name]["sharded"], port_runs[name]["replicated"]
    for k in ("labels", "rounds", "n_contracted", "n_clusters",
              "lb_history"):
        if k == "lb_history":
            np.testing.assert_allclose(s[k], r[k], rtol=RTOL)
        else:
            np.testing.assert_array_equal(s[k], r[k], err_msg=k)
    for k in ("objective", "lower_bound"):
        np.testing.assert_allclose(s[k], r[k], rtol=RTOL, err_msg=k)
    for k, x in port_runs[name]["traced"].items():
        np.testing.assert_array_equal(x, s[k], err_msg=k)
    tr = port_runs[name]["trace"]
    assert tr["shard_edges"].shape[1] == 1
    np.testing.assert_array_equal(tr["lower_bound"], s["lb_history"])


def test_state_sharded_validates_like_reference():
    """The reference's preconditions and messages, checked before any
    round runs; p and d are refused by solve_device."""
    inst = _inst("grid")[1]
    cases = [
        ("pd+", SHARDED, "mode='pd'"),
        ("pd", dataclasses.replace(SHARDED, first_round_cycles45=True),
         "3-cycle separation only"),
        ("pd", dataclasses.replace(SHARDED, graph_impl="dense"),
         "CSR data path only"),
        ("pd", dataclasses.replace(SHARDED, separation_chunk=64),
         "does not stack"),
    ]
    for mode, cfg, msg in cases:
        with pytest.raises(ValueError, match=msg):
            validate_state_sharded(inst, cfg, mode)
        with pytest.raises(ValueError, match=msg):
            api.solve(inst, mode=mode, config=cfg, device=CPU)
    odd = tg.grid_instance(8, 8, seed=1, pad_edges=1000, device=CPU)
    with pytest.raises(ValueError, match="divisible by 16"):
        api.solve(odd, config=SHARDED, device=CPU)
    for mode in ("p", "d"):
        with pytest.raises(ValueError, match="mode='pd'"):
            solve_device(inst, mode, SHARDED)
    with pytest.raises(ValueError, match="warm-start"):
        solve_device(inst, "pd", SHARDED, csr=tg.csr_from_instance(inst))
    with pytest.raises(ValueError, match="mutually exclusive"):
        api.solve_batch(api.stack_instances([inst]), config=SHARDED,
                        device=CPU)


def test_preset_and_registry_key():
    """``pd-state-sharded`` is the reference's preset; without a process
    group it clamps to one shard and equals the replicated solve; the
    registry key carries the resolved shard count."""
    p, jp = api.get_preset("pd-state-sharded"), \
        japi.get_preset("pd-state-sharded")
    assert (p.mode, p.config.cache_key()) == \
        (jp.mode, jp.config.cache_key())
    assert resolve_state_shards(4) == 1 and resolve_state_shards(0) == 1
    inst = _inst("random")[1]
    api.clear_cache()
    r = api.solve(inst, preset="pd-state-sharded", device=CPU)
    ref = api.solve(inst, config=BASE, device=CPU)
    np.testing.assert_array_equal(r.labels.numpy(), ref.labels.numpy())
    entry = api.compiled_solve(preset="pd-state-sharded")
    assert entry is api._compiled("pd", p.config, "cuda", False, 1, "solve",
                                  False, 1)
    res, tr = api.Multicut.from_preset("pd-state-sharded",
                                       device=CPU).solve(inst, trace=True)
    np.testing.assert_array_equal(res.labels.numpy(), r.labels.numpy())
    assert tr.shard_halo.shape == (p.config.max_rounds, 1)


# ---------------------------------------------------------------------------
# Four ranks over gloo
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import dataclasses, os
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.ranks import process_group
    from repro_torch import api
    from repro_torch.core import dist as td
    from repro_torch.core import graph as tg
    from repro_torch.core.solver import SolverConfig
    from repro_torch.roofline import profile_solve_round
    E, N, CHUNK, OUT = %(E)d, %(N)d, %(chunk)d, %(out)r
    FAMILIES = {
        "random": tg.random_instance(60, 0.15, seed=3, pad_edges=E,
                                     pad_nodes=N, device="cpu"),
        "grid": tg.grid_instance(8, 8, seed=1, pad_edges=E, pad_nodes=N,
                                 device="cpu"),
        "cluster": tg.cluster_instance(48, k=4, seed=2, pad_edges=E,
                                       pad_nodes=N, device="cpu"),
    }
    base = SolverConfig(graph_impl="sparse", first_round_cycles45=False)
    out = {}

    def keep(prefix, tree):
        for k, x in tree._asdict().items():
            out[prefix + "/" + k] = x.numpy()


    def solves():
        for name, inst in FAMILIES.items():
            for S in (1, 2, 4):
                cfg = dataclasses.replace(base, state_shards=S)
                keep(f"{name}/S{S}", api.solve(inst, config=cfg,
                                               device="cpu"))
                r, tr = api.solve(inst, config=cfg, trace=True,
                                  device="cpu")
                keep(f"{name}/S{S}/traced", r)
                keep(f"{name}/S{S}/trace", tr)


    def streamed():
        u, v, c = tg.to_host_edges(tg.grid_instance(8, 8, seed=1,
                                                    device="cpu"))
        Es = tg.round_up_edges(len(u), state_shards=4)

        def chunks():
            for i in range(0, len(u), CHUNK):
                yield u[i:i + CHUNK], v[i:i + CHUNK], c[i:i + CHUNK]

        part, stats = tg.make_instance_streamed(chunks(), N, Es,
                                                state_shards=4,
                                                device="cpu")
        out["streamed/kind"] = np.array(type(part).__name__)
        keep("streamed/range", part)
        out["streamed/stats"] = np.array(stats)
        cfg = dataclasses.replace(base, state_shards=4)
        keep("streamed/result", api.solve(part, config=cfg, device="cpu"))
        full = tg.make_instance(u, v, c, N, pad_edges=Es, device="cpu")
        keep("streamed/full", api.solve(full, config=cfg, device="cpu"))


    def profiles(rank):
        for S in (2, 4):
            grp = td.state_group(S)
            if rank < S:
                with td.count_collective_bytes() as sent:
                    td.all_gather(torch.zeros(5, dtype=torch.int64), grp)
                out[f"prof/S{S}/known"] = np.array([sent["bytes"],
                                                    sent["calls"]])
            cfg = dataclasses.replace(base, state_shards=S, **%(prof)r)
            prof = profile_solve_round(FAMILIES["grid"], cfg)
            out[f"prof/S{S}/none"] = np.array(prof is None)
            if prof is None:
                continue
            for ph, rec in prof["phases"].items():
                for k, x in rec.items():
                    if isinstance(x, (bool, int, float)):
                        out[f"prof/S{S}/{ph}/{k}"] = np.array(x)


    with process_group("gloo") as (rank, world):
        solves()
        streamed()
        profiles(rank)
    out["group_destroyed"] = np.array(not dist.is_initialized())
    np.savez(os.path.join(OUT, f"rank{rank}.npz"), **out)
""")


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo4")
    code = WORKER % dict(E=PAD_EDGES, N=PAD_NODES, chunk=STREAM_CHUNK,
                         out=str(d), prof=PROF)
    spawn(code, world=4, store=d / "store", timeout=300)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_gloo_shard_counts_bit_identical(name, gloo_runs, port_runs):
    """S = 1, 2 and 4 over gloo: every result leaf (labels, histories,
    objective, bound) bit-identical across shard counts and ranks, and to
    the in-process solve without a process group (S = 1 over a gloo group
    of one gives the same bits as no group)."""
    want = port_runs[name]["sharded"]
    for rank, run in enumerate(gloo_runs):
        for S in (1, 2, 4):
            for k, x in want.items():
                np.testing.assert_array_equal(
                    run[f"{name}/S{S}/{k}"], x, err_msg=f"rank {rank} S {S} "
                    f"{k}")


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_gloo_trace_rows(name, gloo_runs, port_runs):
    """Traced = untraced at every S; the per-shard rows have width S, and
    summed over the shards equal the S = 1 row; the other rows equal the
    in-process trace bit for bit."""
    one = port_runs[name]["trace"]
    for run in gloo_runs:
        for S in (1, 2, 4):
            for k, x in port_runs[name]["sharded"].items():
                np.testing.assert_array_equal(run[f"{name}/S{S}/traced/{k}"],
                                              x, err_msg=f"S {S} {k}")
            for k, x in one.items():
                got = run[f"{name}/S{S}/trace/{k}"]
                if k.startswith("shard_"):
                    assert got.shape == (x.shape[0], S)
                    got = got.sum(-1, keepdims=True)
                np.testing.assert_array_equal(got, x, err_msg=f"S {S} {k}")


def test_gloo_streamed_ingest_by_range(gloo_runs):
    """``make_instance_streamed(state_shards=4)``: each rank keeps only its
    quarter (an EdgeRange); the ranges in rank order are the generator's
    padded leaves; each rank's peak host slots are E/4 + one chunk; the
    solve of the ranges equals the solve of the full instance."""
    ref = jg.grid_instance(8, 8, seed=1)
    u, v, c = jg.to_host_edges(ref)
    Es = jg.round_up_edges(len(u), state_shards=4)
    full = jg.make_instance(u, v, c, PAD_NODES, pad_edges=Es)
    for k, leaf in zip(("u", "v", "cost", "edge_valid"), full[:4]):
        got = np.concatenate([r[f"streamed/range/{k}"] for r in gloo_runs])
        np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=k)
    n_chunks = -(-len(u) // STREAM_CHUNK)
    for run in gloo_runs:
        assert str(run["streamed/kind"]) == "EdgeRange"
        np.testing.assert_array_equal(run["streamed/range/node_valid"],
                                      np.asarray(full.node_valid))
        np.testing.assert_array_equal(
            run["streamed/stats"], [n_chunks, len(u),
                                    Es // 4 + STREAM_CHUNK])
        for k in ("labels", "rounds", "lb_history", "n_contracted",
                  "n_clusters", "objective", "lower_bound"):
            np.testing.assert_array_equal(run[f"streamed/result/{k}"],
                                          run[f"streamed/full/{k}"],
                                          err_msg=k)


def test_gloo_groups_destroyed(gloo_runs):
    """Every rank left ``process_group`` with its group (and the state
    subgroups made from it) destroyed, before it wrote its results."""
    for run in gloo_runs:
        assert bool(run["group_destroyed"])


@pytest.mark.parametrize("S", [2, 4])
def test_gloo_sharded_profile(S, gloo_runs):
    """``profile_solve_round`` of the state-sharded round over S gloo
    ranks: ranks past S get None; in each phase the job totals are each
    rank's count summed over the group and the per-device numbers its
    maximum, the same on every rank, and where every rank counted the
    same, job = per-device × S (the reference's identity); the wall is
    the slowest rank's. Collective bytes: one known all_gather of five
    int64 counts 40 bytes on each rank, and MP's equal what its two
    collectives send: the halo exchange of the 3T slot costs and
    blocked_sum's 16/S partials, all float32."""
    from repro_torch.core.graph import build_csr
    from repro_torch.core.sharded import _separate_triangles_state_sharded
    from repro_torch.roofline import PHASES
    runs = gloo_runs[:S]
    assert not any(bool(r[f"prof/S{S}/none"]) for r in runs)
    assert all(bool(r[f"prof/S{S}/none"]) for r in gloo_runs[S:])
    for r in runs:
        assert r[f"prof/S{S}/known"].tolist() == [40, 1]
    keys = ("flops", "bytes_accessed", "collective_bytes", "torch_ops",
            "kernel_flops", "kernel_bytes")
    for ph in PHASES:
        def get(r, k):
            return r[f"prof/S{S}/{ph}/{k}"].item()
        for k in keys:
            mine = [get(r, f"rank_{k}") for r in runs]
            for r in runs:
                assert get(r, k) == sum(mine), (ph, k)
                assert get(r, f"{k}_per_device") == max(mine), (ph, k)
                if get(r, "same_on_every_rank"):
                    assert get(r, k) == S * get(r, f"{k}_per_device")
        assert len({get(r, "wall_s") for r in runs}) == 1
        assert all(get(r, "wall_s") >= get(r, "rank_wall_s") for r in runs)
        assert get(runs[0], "collective_bytes_per_device") > 0, ph
    inst = _inst("grid")[1]
    cfg = dataclasses.replace(BASE, state_shards=1, **PROF)
    csr = build_csr(inst.u, inst.v, inst.edge_valid, inst.num_nodes)
    tri, _ = _separate_triangles_state_sharded(
        inst.u, inst.v, inst.cost, inst.edge_valid, csr, inst.num_nodes,
        cfg, 1, None, None)
    want = 4 * 3 * tri.shape[0] + 4 * (16 // S)
    for r in runs:
        assert r[f"prof/S{S}/message_passing/rank_collective_bytes"] \
            .item() == want
