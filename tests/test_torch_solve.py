"""The slice as a whole: ``repro_torch.api.solve(..., device="cpu")`` against
``repro.api.solve(..., graph_impl="sparse")`` on a random, a grid and a
cluster instance, with ``pd``, ``pd+`` and the ``pd-chunked`` preset; plus
the API's routing rules and the import boundary of the port.

All three instances share one padded shape, so the reference compiles
once per (mode, config), not once per instance. Integer outputs (labels,
rounds, per-round contraction and cluster counts) must be exact. The
objective, lower bound and lower-bound history are float sums that torch
and XLA reduce in different orders, a few float32 ulps apart (measured
≤ 4e-7 relative): held at rtol 1e-5.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.convert import instance_from_numpy, result_to_numpy  # noqa: E402,E501
from repro_torch.core import graph as tg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
PAD = dict(pad_nodes=576, pad_edges=3600)
INSTANCES = {
    "grid": lambda: jg.grid_instance(24, 24, seed=0, **PAD),
    "random": lambda: jg.random_instance(300, 0.02, seed=1, **PAD),
    "cluster": lambda: jg.cluster_instance(120, seed=2, **PAD),
}
RUNS = {"pd": dict(mode="pd"), "pd+": dict(mode="pd+"),
        "pd-chunked": dict(preset="pd-chunked")}


def _check(t, j):
    for f in ("labels", "rounds", "n_contracted", "n_clusters"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)),
                                      err_msg=f)
    for f in ("objective", "lower_bound", "lb_history"):
        np.testing.assert_allclose(getattr(t, f), np.asarray(getattr(j, f)),
                                   rtol=RTOL, err_msg=f)


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_solve_matches_reference(name, run):
    ji = INSTANCES[name]()
    ti = instance_from_numpy(*[np.asarray(x) for x in ji], device="cpu")
    kw = RUNS[run]
    jr = japi.solve(ji, graph_impl="sparse", **kw)
    tr = result_to_numpy(tapi.solve(ti, graph_impl="sparse", device="cpu",
                                    **kw))
    _check(tr, jr)
    assert int(tr.rounds) >= 2
    assert float(tr.lower_bound) <= float(tr.objective) + 1e-4


def test_backends_and_facade_agree_on_cpu():
    """On CPU tensors the default kernel backend runs the plain versions,
    so it equals backend="reference" exactly; the facade is a thin
    wrapper; the default auto path resolves to sparse above 256 nodes."""
    inst = tg.grid_instance(20, 20, seed=5, device="cpu")
    a = result_to_numpy(tapi.solve(inst, device="cpu"))
    b = result_to_numpy(tapi.solve(inst, backend="reference", device="cpu"))
    c = result_to_numpy(tapi.Multicut.from_preset(
        "paper-pd", device="cpu").solve(inst))
    d = result_to_numpy(tapi.solve(inst, device="cpu",
                                   tune_sparse_caps=True))
    for x in (b, c, d):
        for f, g in zip(a, x):
            np.testing.assert_array_equal(f, g)
    labels = a.labels
    assert labels.shape == (400,) and labels.min() >= 0
    assert len(np.unique(labels)) == int(a.n_clusters[int(a.rounds) - 1])


def test_api_raises_for_unported_parts():
    """What ROADMAP Queue 1 items 7, 9 and 13 ported now runs: every mode
    on the dense path (auto below 257 padded nodes), mode p on the sparse
    path, the traced solve, ``state_shards``, which without a process
    group clamps to one shard and equals the replicated sparse solve, and
    ``separation_shards``, which without a card clamps to one shard and
    equals the unsharded sparse solve. What the API refuses still
    raises."""
    inst = tg.grid_instance(6, 6, seed=0, device="cpu")   # 36 nodes: dense
    for mode in ("p", "pd", "pd+", "d"):
        res = tapi.solve(inst, mode=mode, device="cpu")
        assert res.labels.shape == (36,) and int(res.rounds) >= 1
    res = tapi.solve(inst, mode="p", graph_impl="sparse", device="cpu")
    assert int(res.rounds) >= 1 and bool(res.lower_bound.isneginf())
    res, tr = tapi.solve(inst, graph_impl="sparse", trace=True,
                         device="cpu")
    assert int(tr.rounds) == int(res.rounds) >= 1
    cfg = tapi.SolverConfig(state_shards=2, graph_impl="sparse",
                            first_round_cycles45=False)
    padded = tg.grid_instance(
        6, 6, seed=0, device="cpu",
        pad_edges=tg.round_up_edges(int(inst.edge_valid.sum())))
    res = tapi.solve(padded, config=cfg, device="cpu")
    ref = tapi.solve(padded, config=dataclasses.replace(cfg, state_shards=0),
                     device="cpu")
    for k in ("labels", "rounds", "n_contracted", "n_clusters"):
        assert torch.equal(getattr(res, k), getattr(ref, k)), k
    res = tapi.solve(inst, config=tapi.SolverConfig(separation_shards=2,
                                                    graph_impl="sparse"),
                     device="cpu")
    ref = tapi.solve(inst, graph_impl="sparse", device="cpu")
    for k in ("labels", "rounds", "objective", "lower_bound"):
        assert torch.equal(getattr(res, k), getattr(ref, k)), k
    with pytest.raises(ValueError, match="unknown backend"):
        tapi.solve(inst, backend="pallas", device="cpu")
    assert set(tapi.list_presets()) >= {"paper-pd", "paper-pd+", "pd-opt",
                                        "pd-sparse", "pd-chunked",
                                        "pd-sharded"}
    assert tapi.SolverConfig().cache_key() == \
        japi.SolverConfig().cache_key()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tapi.solve(inst, graph_impl="sparse")


def test_port_imports_no_jax():
    """Importing the port (the LM serving and training modules, the solve
    server, delta solves, observability and the solve trace, the batch
    and registry entry points, the baselines, the roofline profile, the
    multicut arch config, the collectives, the sharded solve and the
    local rank launcher included, the modules that shard separation,
    batches and the roofline profile, the sparse substrate, the GNN and
    recsys models, their configs, the owner-partitioned block, the meshes
    and the six examples, the sharding plans, the pod dry-run and the
    roofline table), and chip_smoke.py's own imports, load no jax and no
    module of the JAX package."""
    code = (
        "import sys, runpy\n"
        "import repro_torch.api, repro_torch.convert\n"
        "import repro_torch.kernels.triangle_mp.ops\n"
        "import repro_torch.kernels.cycle_intersect.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.contract_matmul.ops\n"
        "import repro_torch.models.transformer, repro_torch.configs\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.train, repro_torch.data.synthetic\n"
        "import repro_torch.configs.llama4_scout_17b_a16e\n"
        "import repro_torch.configs.grok_1_314b\n"
        "import repro_torch.serve, repro_torch.incremental, repro_torch.obs\n"
        "from repro_torch.api import (solve_batch, solve_delta,\n"
        "    solve_with_state, stack_instances, unstack_results, tree_ready,\n"
        "    compiled_solve, compiled_delta, trace_count, cache_info)\n"
        "from repro_torch.core.dist import (resolve_batch_shards,\n"
        "    resolve_separation_shards, shard_devices)\n"
        "import repro_torch.obs.trace, repro_torch.core.baselines\n"
        "import repro_torch.roofline, repro_torch.configs.rama_multicut\n"
        "import repro_torch.core.dist, repro_torch.core.sharded\n"
        "import repro_torch.launch.ranks, repro_torch.core.cycles\n"
        "import repro_torch.core.solver, repro_torch.roofline.solver\n"
        "import repro_torch.roofline.analysis, repro_torch.serve.engine\n"
        "import repro_torch.sparse, repro_torch.sparse.spmm\n"
        "import repro_torch.sparse.embedding_bag, repro_torch.sparse.sampler\n"
        "import repro_torch.models.gnn.common, repro_torch.models.gnn.egnn\n"
        "import repro_torch.models.gnn.dimenet, repro_torch.models.gnn.mace\n"
        "import repro_torch.models.gnn.graphcast, repro_torch.models.recsys\n"
        "import repro_torch.configs.dimenet, repro_torch.configs.egnn\n"
        "import repro_torch.configs.mace, repro_torch.configs.graphcast\n"
        "import repro_torch.configs.wide_deep\n"
        "import repro_torch.examples.gnn_multicut\n"
        "import repro_torch.examples.weather_graphcast\n"
        "import repro_torch.models.gnn.partitioned, repro_torch.launch.mesh\n"
        "import repro_torch.examples.quickstart\n"
        "import repro_torch.examples.image_segmentation\n"
        "import repro_torch.examples.serve_tiles\n"
        "import repro_torch.examples.distributed_multicut\n"
        "import repro_torch.sharding, repro_torch.launch.dryrun\n"
        "import repro_torch.roofline.run\n"
        "runpy.run_path(sys.argv[1], run_name='chip_smoke_import')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "chip_smoke.py")],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_rehearsal_on_cpu():
    """``chip_smoke.py --rehearse`` drives every phase on the CPU at a tiny
    size, then exits 3 with no result line; without a card and without
    ``--rehearse`` it exits nonzero at once and prints nothing."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rehearse"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stderr[-2000:]
    assert "phase 4" in out.stdout and '"ok"' not in out.stdout
    assert "phase 5" in out.stdout and "phase 6" in out.stdout
    assert "phase 7" in out.stdout and "exact tick" in out.stdout
    assert "phase 8" in out.stdout and "streamed ingest" in out.stdout
    assert "phase 9" in out.stdout and "bit-identical to S = 1" in \
        out.stdout and "block decomposition" in out.stdout
    assert "phase 10" in out.stdout and "pd-sharded S = 4: bit-equal" in \
        out.stdout and "batch_shards = 4: bit-identical" in out.stdout
    assert "router with batch_shards=2" in out.stdout and \
        "S = 2 rank 1 contraction" in out.stdout
    assert "pd-sharded at S = 1, 2, 4: triangle_mp T" in out.stdout and \
        "the batch_shards=2 route: triangle_mp T" in out.stdout and \
        "each equal to its plain version" in out.stdout
    assert "traced pd+ sparse: bit-equal" in out.stdout
    assert "phase 11" in out.stdout and "grok-1-314b decode at context" \
        in out.stdout and "params bit-equal True" in out.stdout
    assert "labels equal True" in out.stdout
    assert "phase 12" in out.stdout and "wide-deep train_batch" in \
        out.stdout and "graphcast on minibatch_lg" in out.stdout and \
        "gnn_multicut: 60 EGNN steps" in out.stdout
    assert "phase 13" in out.stdout and "partitioned block, d 16" in \
        out.stdout and "drop plan (halo" in out.stdout
    for name in ("quickstart", "image_segmentation", "serve_tiles",
                 "distributed_multicut"):
        assert f"example {name}: asserts passed" in out.stdout, name
    assert "phase 14" in out.stdout and "cells traced in" in out.stdout \
        and ", 0 failures; the child ran" in out.stdout
    assert "dry-run [16x16] grok-1-314b/long_500k" in out.stdout
    assert "logits bit-equal True to the plain prefill" in out.stdout
    assert "dry-run of the same cell: argument bytes" in out.stdout
    if not torch.cuda.is_available():
        bare = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=120)
        assert bare.returncode != 0 and bare.stdout == ""
