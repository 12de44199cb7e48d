"""The port's sharding plans (``repro_torch.sharding`` and the registry's
``for_mesh``/``state_shardings``/``kv_pspec``/``input_shardings``)
against the JAX package's, and the sharded steps against the unsharded
ones.

Every spec of every arch equals the reference's entry for entry on the
single-pod (16, 16) and multi-pod (2, 16, 16) meshes: the reference's on
a ``jax.sharding.AbstractMesh``, the port's on the production
``DeviceMesh`` over a ``fake`` group of 256 and 512 ranks in one
subprocess, with each state leaf's local shard shape equal to
``NamedSharding.shard_shape``. The MoE block at 2 and 4 dispatch groups
equals the JAX block at the same groups (float32, rtol 1e-5). One spawn
of 4 gloo ranks on ``make_debug_mesh(2, 2)`` runs a reduced dense LM
train step, a reduced MoE prefill, a GNN (egnn) train step and a
wide-deep train step with DTensor state and inputs placed by their plans,
each equal to the same step on plain tensors within 1e-5 of its largest
value in float32 (collective sums add in another order).
"""
import dataclasses
import json
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
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.convert import transformer_params_from_numpy  # noqa: E402
from repro_torch.launch.ranks import spawn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    P, local_shape, placements,
)

ROOT = Path(__file__).resolve().parents[1]
IDS = ["granite-34b", "gemma2-9b", "phi3-mini-3.8b",
       "llama4-scout-17b-a16e", "grok-1-314b", "dimenet", "egnn", "mace",
       "graphcast", "wide-deep", "rama-multicut"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class StandIn:
    """A mesh with the reference's interface (axis_names, shape dict)."""

    def __init__(self, sizes, names):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _norm(spec) -> list:
    """A spec as JSON, entry for entry (a one-name tuple is the name)."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = None if not e else (e[0] if len(e) == 1 else list(e))
        out.append(e)
    return out


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    if hasattr(t, "_fields"):
        if hasattr(t, "spec") and hasattr(t, "mesh"):
            return fn(t)
        return {k: _tree(v, fn) for k, v in zip(t._fields, t)}
    if isinstance(t, (list, tuple)):
        return [_tree(v, fn) for v in t]
    return fn(t)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,spec", [
    ((4, 32, 64), P(None, ("pod", "data"), "model")),
    ((1024, 2, 32), P(("pod", "data", "model"))),
    ((16, 8), P("model", None)),
    ((32, 48, 16), P(("data",), None, "model")),
])
def test_placements_and_local_shapes(shape, spec):
    """``P(None, ("pod", "data"), "model")`` on (pod, data, model) is
    [Shard(1), Shard(1), Shard(2)]; every local shard shape equals JAX's
    ``NamedSharding.shard_shape`` for the same global shape and mesh."""
    from torch.distributed.tensor import Replicate, Shard
    sizes, names = MESHES["multi"]
    mesh = StandIn(sizes, names)
    pl = placements(mesh, spec, shape)
    want_pl = [Replicate()] * 3
    for dim, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            want_pl[names.index(a)] = Shard(dim)
    assert pl == want_pl
    if spec == P(None, ("pod", "data"), "model"):
        assert pl == [Shard(1), Shard(1), Shard(2)]
    jmesh = AbstractMesh(sizes, names)
    want = NamedSharding(jmesh, jax.sharding.PartitionSpec(*spec)) \
        .shard_shape(shape)
    assert local_shape(mesh, spec, shape) == tuple(want)


@pytest.mark.parametrize("shape,spec,why", [
    ((30, 8), P(("data",), None), "does not divide"),
    ((32, 32), P("model", "model"), "used twice"),
    ((32, 8), P(("model", "data"), None), "mesh order"),
    ((32, 8), P("expert", None), "no axis"),
])
def test_placements_refuse_bad_plans(shape, spec, why):
    """An uneven dimension raises, as XLA refuses it (DTensor would shard
    it unevenly), and so does an axis used twice, out of mesh order or
    missing."""
    mesh = StandIn(*MESHES["single"])
    with pytest.raises(ValueError, match=why):
        placements(mesh, spec, shape)


# ---------------------------------------------------------------------------
# every arch's plans against the reference's
# ---------------------------------------------------------------------------

PORT_SPECS = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import get_arch, fake_mode
    from repro_torch.launch.dryrun import fake_group, production_mesh
    from repro_torch.sharding import Sharding, local_shape
    from repro_torch.tree import tree_leaves
    IDS = %(ids)r

    def norm(spec):
        out = []
        for e in spec:
            if isinstance(e, (tuple, list)):
                e = None if not e else (e[0] if len(e) == 1 else list(e))
            out.append(e)
        return out

    def tree(t, fn):
        if isinstance(t, Sharding):
            return fn(t)
        if isinstance(t, dict):
            return {k: tree(v, fn) for k, v in t.items()}
        if hasattr(t, "_fields"):
            return {k: tree(v, fn) for k, v in zip(t._fields, t)}
        return [tree(v, fn) for v in t]

    def shapes(state, sh, mesh):
        leaves = tree_leaves(state)
        it = iter(leaves)
        return tree(sh, lambda s: list(local_shape(mesh, s.spec,
                                                   next(it).shape)))

    out = {}
    for name, world, multi in (("single", 256, False),
                               ("multi", 512, True)):
        with fake_group(world):
            mesh = production_mesh(multi)
            for aid in IDS:
                arch = get_arch(aid)
                a = arch.for_mesh(mesh) if hasattr(arch, "for_mesh") \\
                    else arch
                rec = {}
                if a.family == "lm":
                    rec["cfg"] = dict(
                        act_sharding=norm(a.cfg.act_sharding),
                        moe_groups=a.cfg.moe_groups,
                        moe_shard_experts=a.cfg.moe_shard_experts)
                if a.family == "gnn":
                    rec["cfg"] = dict(shard_axes=list(a.shard_axes),
                                      compute_dtype=str(a.compute_dtype))
                for sname, shape in a.shapes.items():
                    st = a.state_shardings(mesh, shape)
                    c = {"state": tree(st, lambda s: norm(s.spec)),
                         "inputs": {k: norm(s.spec) for k, s in
                                    a.input_shardings(mesh, shape).items()}}
                    if a.family == "lm":
                        c["kv"] = norm(a.kv_pspec(mesh, shape))
                        with fake_mode():
                            p = a.abstract_params()
                            c["local"] = {"params": shapes(p, st["params"],
                                                           mesh)}
                            if shape.kind == "decode":
                                c["local"]["cache"] = shapes(
                                    a.abstract_cache(shape), st["cache"],
                                    mesh)
                    if a.family == "recsys":
                        with fake_mode():
                            c["local"] = {"params": shapes(
                                a.abstract_params(), st["params"], mesh)}
                    rec[sname] = c
                out[f"{name}/{aid}"] = rec
            del mesh
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def port_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs") / "port.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", PORT_SPECS % dict(ids=IDS),
                        str(path)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(path.read_text())


def _jax_state_shapes(arch, shape, st):
    """Local shard shapes of the reference's params (and cache)."""
    out = {}
    p = arch.abstract_params()
    out["params"] = jax.tree.map(
        lambda s, x: list(s.shard_shape(x.shape)), st["params"], p,
        is_leaf=lambda x: isinstance(x, NamedSharding))
    if shape.kind == "decode" and arch.family == "lm":
        c = arch.abstract_cache(shape)
        out["cache"] = {k: list(st["cache"][k].shard_shape(c[k].shape))
                        for k in c}
    return out


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("aid", IDS)
def test_plans_equal_reference(port_specs, aid, mesh_name):
    """``for_mesh``'s config updates, every ``state_shardings`` spec (the
    params, the optimizer state, the cache), ``kv_pspec`` and every
    ``input_shardings`` spec of every shape equal the JAX registry's
    entry for entry, grok-1's expert fallback and the sequence-sharded
    long_500k cache included; the LM and recsys local shard shapes equal
    ``NamedSharding.shard_shape``."""
    got = port_specs[f"{mesh_name}/{aid}"]
    mesh = AbstractMesh(*MESHES[mesh_name])
    arch = jget_arch(aid)
    a = arch.for_mesh(mesh) if hasattr(arch, "for_mesh") else arch
    if a.family == "lm":
        assert got["cfg"] == dict(
            act_sharding=_norm(a.cfg.act_sharding),
            moe_groups=a.cfg.moe_groups,
            moe_shard_experts=a.cfg.moe_shard_experts)
        # the reference's per-layer cache pins are its kv plan's slices,
        # which the port's in-place cache update keeps
        for k, v in a.cache_pspecs.items():
            assert _norm(v) == got[k]["kv"][1:], (aid, k)
    if a.family == "gnn":
        assert got["cfg"] == dict(shard_axes=list(a.shard_axes),
                                  compute_dtype="torch.bfloat16")
    for sname, shape in a.shapes.items():
        st = a.state_shardings(mesh, shape)
        want = {"state": _tree(st, lambda s: _norm(s.spec)),
                "inputs": {k: _norm(s.spec) for k, s in
                           a.input_shardings(mesh, shape).items()}}
        if a.family == "lm":
            want["kv"] = _norm(a.kv_pspec(mesh, shape))
        if a.family in ("lm", "recsys"):
            want["local"] = _jax_state_shapes(a, shape, st)
        assert got[sname] == want, (aid, sname)
    if aid == "grok-1-314b":          # the expert fallback is exercised
        assert got["cfg"]["moe_shard_experts"] is False
        assert got["train_4k"]["state"]["params"]["layers"]["w_gate"] == \
            [None, None, "data" if mesh_name == "single"
             else ["pod", "data"], "model"]
    if aid == "granite-34b":          # long_500k shards the sequence
        assert got["long_500k"]["kv"][3] is not None


# ---------------------------------------------------------------------------
# the MoE block's dispatch groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [2, 4])
def test_moe_groups_match_jax(groups):
    """``moe_block`` at ``moe_groups`` 2 and 4 (each group its own
    capacity) equals the JAX ``moe_block`` at the same groups, float32,
    and differs from one group (the capacity binds)."""
    jcfg = dataclasses.replace(
        jget_arch("grok-1-314b").cfg, n_layers=1, d_model=32, n_heads=4,
        n_kv_heads=2, head_dim=8, d_ff=48, vocab=64, n_experts=4, top_k=2,
        capacity_factor=1.0, dtype=jnp.float32, param_dtype=jnp.float32,
        act_sharding=None, moe_groups=groups)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(groups)
    h = rng.normal(0, 1, (4, 8, 32)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    want = np.asarray(jtfm.moe_block(jcfg, jlp, jnp.asarray(h)))
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ttfm.TransformerConfig)}
    kw.update(dtype=torch.float32, param_dtype=torch.float32)
    tcfg = ttfm.TransformerConfig(**kw)
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    got = ttfm.moe_block(tcfg, ttfm.layer_params(tp, 0),
                         torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    one = ttfm.moe_block(dataclasses.replace(tcfg, moe_groups=1),
                         ttfm.layer_params(tp, 0), torch.from_numpy(h))
    assert not np.allclose(one.numpy(), want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# sharded steps over 4 gloo ranks
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent('''
    import dataclasses, gc, json
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.ranks import process_group


    def err(a, b):
        a, b = a.detach().double(), b.detach().double()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


    def run(mesh):
        from torch.distributed.tensor.experimental import \\
            implicit_replication
        from repro_torch.configs.base import LMArch, RecsysArch, ShapeCell, \\
            get_arch
        from repro_torch.models import recsys as rs, transformer as tfm
        from repro_torch.sharding import Sharding, distribute
        from repro_torch.train.optimizer import init_opt_state
        from repro_torch.tree import tree_leaves, tree_map

        def place(tree, sh):
            flat = []

            def walk(s):
                if isinstance(s, Sharding):
                    flat.append(s)
                else:
                    for v in (s.values() if isinstance(s, dict) else s):
                        walk(v)
            walk(sh)
            it = iter(flat)
            return tree_map(lambda t: distribute(t, next(it)), tree)

        def full(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        def clone(tree):
            return tree_map(lambda t: t.clone(), tree)

        def train(arch, shape, params, ins, tag):
            """The train step on plain tensors and on DTensors placed by
            the plans: the loss and every updated param."""
            step = arch.step_fn(shape, **({"backend": "reference"}
                                          if arch.family == "lm" else {}))
            p0 = clone(params)
            p0, _, m0 = step(p0, init_opt_state(p0), *ins.values())
            ss = arch.state_shardings(mesh, shape)
            ish = arch.input_shardings(mesh, shape)
            p1 = place(clone(params), ss["params"])
            with implicit_replication():
                p1, _, m1 = step(p1, init_opt_state(p1), *[
                    distribute(v, ish[k]) for k, v in ins.items()])
            out[tag + "_loss"] = err(full(m1["loss"]), m0["loss"])
            out[tag + "_grad_norm"] = err(full(m1["grad_norm"]),
                                          m0["grad_norm"])
            out[tag + "_params"] = max(err(full(a), b) for a, b in
                                       zip(tree_leaves(p1),
                                           tree_leaves(p0)))

        out = {}
        gen = torch.Generator().manual_seed(0)
        cfg = dataclasses.replace(
            get_arch("granite-34b").cfg, n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=1, head_dim=16, d_ff=128, vocab=256,
            dtype=torch.float32)
        arch = LMArch(id="lm", cfg=cfg, grad_accum=2).for_mesh(mesh)
        train(arch, ShapeCell("t", "train", dict(seq_len=16, global_batch=8)),
              tfm.init_params(arch.cfg, gen, "cpu", masters=True),
              {k: torch.randint(0, 256, (8, 16), generator=gen,
                                dtype=torch.int32)
               for k in ("tokens", "targets")}, "lm")
        # 2 rows a rank under grad_accum 4: the step runs 2 microbatches
        # of each rank's rows where the plain step runs 4 of 1 row, and
        # must take the same mean gradient (its own generator: the later
        # cases keep their draws)
        arch = LMArch(id="lm", cfg=cfg, grad_accum=4).for_mesh(mesh)
        out["lowered_microbatches"] = arch.microbatches(4, mesh)[0]
        gen_ga = torch.Generator().manual_seed(1)
        train(arch, ShapeCell("t", "train", dict(seq_len=16, global_batch=4)),
              tfm.init_params(arch.cfg, gen_ga, "cpu", masters=True),
              {k: torch.randint(0, 256, (4, 16), generator=gen_ga,
                                dtype=torch.int32)
               for k in ("tokens", "targets")}, "lmga")

        cfg = dataclasses.replace(
            get_arch("llama4-scout-17b-a16e").cfg, n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64, vocab=256,
            n_experts=4, dtype=torch.float32)
        arch = LMArch(id="moe", cfg=cfg).for_mesh(mesh)
        shape = ShapeCell("p", "prefill", dict(seq_len=16, global_batch=4))
        params = tfm.init_params(arch.cfg, gen, "cpu", masters=True)
        tok = torch.randint(0, 256, (4, 16), generator=gen,
                            dtype=torch.int32)
        step = arch.step_fn(shape, backend="reference")
        want = step(params, tok)
        p1 = place(params, arch.state_shardings(mesh, shape)["params"])
        with implicit_replication():
            got = step(p1, distribute(
                tok, arch.input_shardings(mesh, shape)["tokens"]))
        out["moe_groups"] = arch.cfg.moe_groups
        out["moe_logits"] = err(full(got), want)
        del p1, got

        arch = dataclasses.replace(get_arch("egnn").for_mesh(mesh),
                                   compute_dtype=None)
        shape = arch.shapes["molecule"]
        spec = arch.input_specs(shape)
        N, E = spec["nodes"].shape[0], spec["edges_src"].shape[0]
        ins = {"nodes": torch.randn(spec["nodes"].shape, generator=gen),
               "edges_src": torch.randint(0, N, (E,), generator=gen,
                                          dtype=torch.int32),
               "edges_dst": torch.randint(0, N, (E,), generator=gen,
                                          dtype=torch.int32),
               "node_mask": torch.ones(N, dtype=torch.bool),
               "edge_mask": torch.rand(E, generator=gen) < 0.9,
               "graph_ids": (torch.arange(N) * 128 // N).to(torch.int32),
               "labels_f": torch.randn(128, generator=gen),
               "positions": torch.randn(N, 3, generator=gen)}
        assert list(ins) == list(spec)
        train(arch, shape, arch.init_params(shape, gen), ins, "gnn")

        cfg = dataclasses.replace(get_arch("wide-deep").cfg,
                                  vocab_per_field=64, mlp_dims=(32, 16))
        arch = RecsysArch(id="wd", cfg=cfg)
        train(arch, ShapeCell("t", "train", dict(batch=16)),
              rs.init_params(cfg, gen),
              {"sparse_idx": torch.randint(0, 64, (16, cfg.n_sparse, 1),
                                           generator=gen, dtype=torch.int32),
               "dense_feats": torch.randn(16, cfg.n_dense, generator=gen),
               "labels": (torch.rand(16, generator=gen) < 0.5).float()},
              "recsys")
        return out


    with process_group("gloo") as (rank, world):
        from repro_torch.launch.mesh import make_debug_mesh
        from repro_torch.sharding import clear_dtensor_caches
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        res = run(mesh)
        del mesh
        clear_dtensor_caches()
        gc.collect()
    print(json.dumps(res))
''')


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    outs = spawn(WORKER, world=4, store=d / "store", timeout=400)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


@pytest.mark.parametrize("what", ["lm", "lmga", "moe", "gnn", "recsys"])
def test_sharded_steps_equal_unsharded(gloo_results, what):
    """Over 4 gloo ranks on ``make_debug_mesh(2, 2)``, each step with its
    state and inputs placed by the plans equals the plain step: loss,
    gradient norm and every updated param (the MoE prefill's logits, at
    ``moe_groups`` = 2 from ``for_mesh``) within 1e-5 of the largest
    value, float32. ``lmga`` is the LM step with fewer rows a rank (2)
    than ``grad_accum`` (4), where the sharded step lowers its count of
    microbatches to 2."""
    for res in gloo_results:
        keys = [k for k in res if k.startswith(what + "_")
                and k != "moe_groups"]
        assert keys
        for k in keys:
            assert res[k] <= 1e-5, (k, res[k])
    if what == "moe":
        assert all(r["moe_groups"] == 2 for r in gloo_results)
    if what == "lmga":
        assert all(r["lowered_microbatches"] == 2 for r in gloo_results)
