"""The port's owner-partitioned triplet block
(``repro_torch.models.gnn.partitioned``), its ``all_to_all`` and its
meshes (``repro_torch.launch.mesh``) against the JAX package.

``build_plan``'s five arrays are identical to the reference's (the
reference walks the triplets one by one; the port computes the same
arrays with whole-array numpy), with and without drops at a full halo
or a full shard. The block at D = 1 in-process equals the reference's
``make_triplet_block`` on a one-device mesh and the dense reference; one
spawned run of 4 gloo ranks on ``make_debug_mesh(2, 2)`` gives D = 4,
equal to the dense reference and to the port's D = 1 result, and D = 2
on each data row's ``model`` subgroup. Float32, held at rtol 1e-5 and
atol 1e-5: the block's matmuls and its ``index_add`` sum in another order
than XLA's. The production meshes are built under the ``fake`` backend
in a subprocess.
"""
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.mesh import make_debug_mesh as j_debug_mesh  # noqa: E402
from repro.models.gnn import partitioned as jp  # noqa: E402
from repro_torch.convert import gnn_params_from_numpy  # noqa: E402
from repro_torch.core import dist as td  # noqa: E402
from repro_torch.launch.ranks import spawn  # noqa: E402
from repro_torch.models.gnn import partitioned as tp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("send_idx", "send_mask", "tri_kj", "tri_ji", "tri_mask")
# the block's graph: E edges of width d, T triplets (90 % valid)
E, T, DW = 64, 160, 16


def _triplets(seed, E=E, T=T):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, E, T).astype(np.int32),
            rng.integers(0, E, T).astype(np.int32),
            rng.random(T) < 0.9)


def _inputs(seed=0):
    """Messages and block weights from a seed (numpy), as the JAX
    reference's own test draws them."""
    rng = np.random.default_rng(seed)
    tri = _triplets(seed)
    m = rng.normal(0, 1, (E, DW)).astype(np.float32)
    w = {"w_tri": rng.normal(0, .3, (DW, DW)).astype(np.float32),
         "w_upd": rng.normal(0, .3, (DW, DW)).astype(np.float32)}
    return tri, m, w


def _dense_jax(m, tri, w):
    tri_kj, tri_ji, tri_mask = tri
    mj = jnp.asarray(m)
    msg = jax.nn.silu(mj[tri_kj] @ w["w_tri"]) * tri_mask[:, None]
    agg = jax.ops.segment_sum(msg, tri_ji, num_segments=m.shape[0])
    return np.asarray(mj + jax.nn.silu(agg @ w["w_upd"]))


# (seed, E, T, D, halo_per_peer, tri_per_shard): nothing dropped; a full
# halo (H = 1); a full shard; both caps at once; one shard; many shards
PLAN_CASES = [(0, 64, 160, 8, 32, 64), (1, 64, 160, 4, 16, 160),
              (2, 64, 160, 8, 1, 160), (3, 64, 160, 8, 32, 8),
              (4, 96, 400, 4, 3, 30), (5, 48, 120, 1, 4, 50),
              (6, 128, 600, 16, 2, 40)]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: f"seed{c[0]}")
def test_build_plan_identical_to_reference(case):
    seed, n_edges, n_tri, D, H, TL = case
    tri = _triplets(seed, n_edges, n_tri)
    want = jp.build_plan(*tri, n_edges, D, H, TL)
    got = tp.build_plan(*tri, n_edges, D, H, TL, device="cpu")
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.e_local, got.halo) == (want.e_local, want.halo)
    kept, valid = int(got.tri_mask.sum()), int(tri[2].sum())
    if seed in (2, 3, 4):          # the capped cases drop triplets
        assert 0 < kept < valid
    elif seed == 1:
        assert kept == valid


def test_build_plan_rejects_bad_input():
    tri = _triplets(0)
    with pytest.raises(ValueError, match="split"):
        tp.build_plan(*tri, E, 5, 4, 32, device="cpu")
    with pytest.raises(ValueError, match="tri_kj"):
        tp.build_plan(tri[0] + E, tri[1], tri[2], E, 4, 4, 32,
                      device="cpu")


def test_abstract_plan_matches_reference():
    want = jp.abstract_plan(64, 8, 32, 64)
    got = tp.abstract_plan(64, 8, 32, 64)
    conc = tp.build_plan(*_triplets(4), 64, 8, 32, 64, device="cpu")
    for f in FIELDS:
        a, c = getattr(got, f), getattr(conc, f)
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(getattr(want, f).shape) \
            == tuple(c.shape), f
        assert a.dtype == c.dtype, f
        assert str(a.dtype).split(".")[-1] == \
            np.dtype(getattr(want, f).dtype).name, f
    assert (got.e_local, got.halo) == (want.e_local, want.halo)


def test_block_one_shard_matches_reference():
    """D = 1 in-process, no process group: the port's block on the whole
    (E, d) against the reference's block on a one-device mesh, the dense
    reference, and the port's own dense formulation."""
    tri, m, w = _inputs()
    jplan = jp.build_plan(*tri, E, 1, 8, T)
    want = np.asarray(jp.make_triplet_block(j_debug_mesh(1, 1))(
        jnp.asarray(m), jplan, {k: jnp.asarray(v) for k, v in w.items()}))
    dense = _dense_jax(m, tri, w)
    tw = gnn_params_from_numpy(w, "partitioned", device="cpu")
    plan = tp.build_plan(*tri, E, 1, 8, T, device="cpu")
    tm = torch.from_numpy(m)
    got = tp.make_triplet_block()(tm, plan, tw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, dense, **TOL)
    port_dense = tp.dense_triplet_block(
        tm, *(torch.from_numpy(np.asarray(a)) for a in tri), tw).numpy()
    np.testing.assert_allclose(port_dense, dense, **TOL)
    with pytest.raises(ValueError, match="2 shards"):
        tp.make_triplet_block()(tm[:E // 2], tp.build_plan(
            *tri, E, 2, 8, T, device="cpu"), tw)


def test_all_to_all_without_a_group_is_the_identity():
    x = torch.arange(12).reshape(3, 4)
    assert td.all_to_all(x, None) is x
    assert "all_to_all" in td.__all__


# ---------------------------------------------------------------------------
# Four ranks over gloo
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import os
    import numpy as np, torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.core import dist as td
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.ranks import process_group
    from repro_torch.models.gnn import partitioned as tp
    OUT, E, T, DW = %(out)r, %(E)d, %(T)d, %(DW)d
""") + textwrap.dedent(inspect.getsource(_triplets)) \
    + textwrap.dedent(inspect.getsource(_inputs)) + textwrap.dedent("""
    tri, m, w = _inputs()
    m = torch.from_numpy(m)
    w = {k: torch.from_numpy(v) for k, v in w.items()}
    out = {}


    def work(rank):
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        plan = tp.build_plan(*tri, E, 4, E // 4, T, device="cpu")
        el = plan.e_local
        block = tp.make_triplet_block(mesh)
        with td.count_collective_bytes() as rec:
            out["d4"] = block(m[rank * el:(rank + 1) * el], plan, w).numpy()
        out["bytes"] = np.array([rec["bytes"], rec["calls"]])
        out["kept4"] = np.array(int(plan.tri_mask.sum()))
        # D = 2 over the model axis: each data row is its own group
        plan2 = tp.build_plan(*tri, E, 2, E // 2, T, device="cpu")
        el2, r2 = plan2.e_local, rank %% 2
        out["d2"] = tp.make_triplet_block(mesh, axes=("model",))(
            m[r2 * el2:(r2 + 1) * el2], plan2, w).numpy()
        W = dist.group.WORLD
        x = torch.arange(4 * 3, dtype=torch.int32).reshape(4, 3) + 100 * rank
        out["a2a"] = td.all_to_all(x, W).numpy()
        out["a2a_bool"] = td.all_to_all(x %% 3 == 0, W).numpy()


    with process_group("gloo") as (rank, world):
        work(rank)
    out["group_destroyed"] = np.array(not dist.is_initialized())
    np.savez(os.path.join(OUT, f"rank{rank}.npz"), **out)
""")


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo4")
    spawn(WORKER % dict(out=str(d), E=E, T=T, DW=DW), world=4,
          store=d / "store", timeout=300)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def test_gloo_block_four_shards(gloo_runs):
    """D = 4 over 4 gloo ranks equals the dense reference and the port's
    D = 1 block; each rank sends D·H·d·4 bytes in one all_to_all."""
    tri, m, w = _inputs()
    dense = _dense_jax(m, tri, w)
    one = tp.make_triplet_block()(
        torch.from_numpy(m), tp.build_plan(*tri, E, 1, 8, T, device="cpu"),
        gnn_params_from_numpy(w, "partitioned", device="cpu")).numpy()
    got = np.concatenate([run["d4"] for run in gloo_runs])
    np.testing.assert_allclose(got, dense, **TOL)
    np.testing.assert_allclose(got, one, **TOL)
    D, H = 4, E // 4
    for run in gloo_runs:
        assert int(run["kept4"]) == int(tri[2].sum())
        assert run["bytes"].tolist() == [D * H * DW * 4, 1]
        assert bool(run["group_destroyed"])


def test_gloo_block_model_subgroups(gloo_runs):
    """D = 2 over the ``model`` axis: ranks (0, 1) and (2, 3) each run
    the whole block, equal to the dense reference."""
    tri, m, w = _inputs()
    dense = _dense_jax(m, tri, w)
    for row in (gloo_runs[:2], gloo_runs[2:]):
        got = np.concatenate([run["d2"] for run in row])
        np.testing.assert_allclose(got, dense, **TOL)


def test_gloo_all_to_all_exact(gloo_runs):
    """Row r of rank p's result is row p of rank r's operand, exactly;
    bool crosses the wire as uint8 and comes back bool."""
    for p, run in enumerate(gloo_runs):
        want = np.stack([np.arange(p * 3, p * 3 + 3, dtype=np.int32)
                         + 100 * r for r in range(4)])
        np.testing.assert_array_equal(run["a2a"], want)
        assert run["a2a_bool"].dtype == np.bool_
        np.testing.assert_array_equal(run["a2a_bool"], want % 3 == 0)


def test_production_meshes_under_fake_backend():
    """``make_production_mesh`` at 256 and 512 fake ranks: shapes, axis
    names, ``data_axes`` and ``model_axis``; a world of another size is
    refused, and so is a missing group."""
    code = textwrap.dedent("""
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch import mesh as M
        try:
            M.make_debug_mesh(1, 1, device_type="cpu")
        except RuntimeError as e:
            print("no group:", "none is initialised" in str(e))
        dist.init_process_group("fake", store=FakeStore(), rank=5,
                                world_size=256)
        m = M.make_production_mesh(device_type="cpu")
        print(tuple(m.mesh.shape), m.mesh_dim_names, M.data_axes(m),
              M.model_axis(m), list(m.get_coordinate()))
        try:
            M.make_production_mesh(multi_pod=True, device_type="cpu")
        except ValueError as e:
            print("refused:", "needs 512 ranks" in str(e))
        del m
        dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=300,
                                world_size=512)
        m = M.make_production_mesh(multi_pod=True, device_type="cpu")
        print(tuple(m.mesh.shape), m.mesh_dim_names, M.data_axes(m),
              M.model_axis(m), list(m.get_coordinate()))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines() == [
        "no group: True",
        "(16, 16) ('data', 'model') ('data',) model [0, 5]",
        "refused: True",
        "(2, 16, 16) ('pod', 'data', 'model') ('pod', 'data') model "
        "[1, 2, 12]"]
