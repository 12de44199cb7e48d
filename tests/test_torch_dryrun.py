"""The port's pod dry-run (``repro_torch.launch.dryrun``), its collective
bytes (``repro_torch.roofline.analysis.collective_bytes``) and the
roofline table (``repro_torch.roofline.run``) against the JAX package.

One subprocess runs the reference's ``dryrun_cell`` on a 2x2 mesh of 4
faked CPU devices for reduced configs (a dense LM's train, prefill and
decode, grok-1's decode with its expert fallback, llama4's train,
dimenet's molecule step, wide-deep's train and retrieval); another traces
the port on a ``fake`` group of 4 ranks. The port's per-rank
``argument_size_bytes`` equals the reference's exactly, its records have
the reference's keys, a known redistribute's collective bytes are
counted by kind (an all-reduce twice), and the LM depth and microbatch
variants extrapolate to what a full trace counts (within 1e-3). The CLI traces
one full-width cell on a fake group of 256 ranks.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]

# reduced configs, the same field values on both sides: (cell id, arch,
# shape, config overrides, arch overrides)
LM = dict(n_layers=2, d_model=64, n_heads=4, head_dim=16, d_ff=128,
          vocab=256)
CELLS = [
    ("dense-train", "granite-34b", "train_4k", dict(LM, n_kv_heads=1), {}),
    ("dense-prefill", "granite-34b", "prefill_32k", dict(LM, n_kv_heads=1),
     {}),
    ("dense-decode", "granite-34b", "decode_32k", dict(LM, n_kv_heads=1),
     {}),
    ("grok-decode", "grok-1-314b", "decode_32k",
     dict(LM, n_kv_heads=2, d_ff=64, n_experts=3), {}),
    ("llama4-train", "llama4-scout-17b-a16e", "train_4k",
     dict(LM, n_kv_heads=2, d_ff=64, n_experts=4), {}),
    ("dimenet", "dimenet", "molecule", {}, {}),
    ("widedeep-train", "wide-deep", "train_batch",
     dict(vocab_per_field=1024), {}),
    ("widedeep-retrieval", "wide-deep", "retrieval_cand",
     dict(vocab_per_field=1024), {}),
]
REFERENCE_KEYS = {"arch", "shape", "mesh", "devices", "compile_s", "flops",
                  "bytes_accessed", "argument_size_bytes",
                  "output_size_bytes", "temp_size_bytes",
                  "peak_bytes_per_device"}

JAX_SIDE = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    assert len(jax.devices()) == 4      # before dryrun's own XLA_FLAGS
    from repro.configs import base
    from repro.launch import dryrun
    from repro.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(2, 2)
    out = {}
    for cid, aid, shape, cfg_kw, arch_kw in %(cells)r:
        arch = base.get_arch(aid)
        arch = dataclasses.replace(
            arch, cfg=dataclasses.replace(arch.cfg, **cfg_kw), **arch_kw)
        base.REGISTRY["__tmp__"] = arch
        rec, _, _ = dryrun.dryrun_cell("__tmp__", shape, mesh,
                                       verbose=False)
        out[cid] = rec["argument_size_bytes"]
    json.dump(out, open(sys.argv[1], "w"))
""")

PORT_SIDE = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.configs import base
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analysis import collective_bytes
    from repro_torch.roofline.run import measure_cell
    from repro_torch.roofline.solver import LocalWorkCounter
    from repro_torch.launch.mesh import make_debug_mesh
    out = {"args": {}}
    with dryrun.fake_group(4):
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        for cid, aid, shape, cfg_kw, arch_kw in %(cells)r:
            arch = base.get_arch(aid)
            arch = dataclasses.replace(
                arch, cfg=dataclasses.replace(arch.cfg, **cfg_kw),
                **arch_kw)
            if hasattr(arch, "for_mesh"):
                arch = arch.for_mesh(mesh)
            out["args"][cid] = dryrun._arguments(arch, arch.shapes[shape],
                                                 mesh)
        # a known redistribute of an (8, 4) float32 tensor on the data axis
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            t = torch.empty(4, 4)
            x = DTensor.from_local(t, mesh, [Shard(0), Replicate()],
                                   run_check=False)
            p = DTensor.from_local(torch.empty(8, 4), mesh,
                                   [Partial(), Replicate()],
                                   run_check=False)
            with LocalWorkCounter() as wc:
                x.redistribute(mesh, [Replicate(), Replicate()])
                p.redistribute(mesh, [Shard(0), Replicate()])
                p.redistribute(mesh, [Replicate(), Replicate()])
        out["issued"] = wc.collectives
        out["coll"] = collective_bytes(wc.collectives, explicit_bytes=12)
        # the depth and microbatch variants against a full trace, small
        base.LM_SHAPES["train_4k"] = dataclasses.replace(
            base.LM_SHAPES["train_4k"], dims=dict(seq_len=16,
                                                  global_batch=16))
        a3 = dataclasses.replace(
            base.get_arch("granite-34b"), grad_accum=4,
            cfg=dataclasses.replace(base.get_arch("granite-34b").cfg,
                                    **dict(%(lm)r, n_layers=3,
                                           n_kv_heads=1)))
        full = dryrun.dryrun_cell("granite-34b", "train_4k", mesh,
                                  arch=a3, full_depth=True, verbose=False)
        extra = dryrun.dryrun_cell("granite-34b", "train_4k", mesh,
                                   arch=a3, verbose=False)
        roof = measure_cell("granite-34b", "train_4k", mesh, arch=a3)
        out["full"], out["extra"], out["roof"] = full, extra, roof
        del mesh
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both subprocesses, run at once: (reference's, port's) JSON."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", code % dict(
        cells=CELLS, lm=LM), str(d / f"{name}.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, code in (("jax", JAX_SIDE), ("port", PORT_SIDE))]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return (json.loads((d / "jax.json").read_text()),
            json.loads((d / "port.json").read_text()))


@pytest.mark.parametrize("cid", [c[0] for c in CELLS])
def test_argument_bytes_equal_reference(sides, cid):
    """The port's per-rank argument bytes (state and inputs placed by its
    plans) equal XLA's ``argument_size_in_bytes`` on the same 2x2 mesh."""
    jax_side, port = sides
    assert port["args"][cid] == jax_side[cid], cid


def test_collective_bytes_of_known_redistributes(sides):
    """An all-gather of the (8, 4) float32 tensor counts its 128-byte
    result, a reduce-scatter its 64-byte shard, an all-reduce twice its
    128 bytes; the port's own collectives add under "explicit"."""
    port = sides[1]
    assert [tuple(x) for x in port["issued"]] == [
        ("all-gather", 128), ("reduce-scatter", 64), ("all-reduce", 128)]
    c = port["coll"]
    assert (c["all-gather"], c["reduce-scatter"], c["all-reduce"],
            c["explicit"]) == (128, 64, 256, 12)
    assert c["total"] == 128 + 64 + 256 + 12


def test_record_has_reference_keys(sides):
    port = sides[1]
    for rec in (port["full"], port["extra"]):
        assert REFERENCE_KEYS <= set(rec)
        assert rec["peak_bytes_per_device"] == rec["argument_size_bytes"] \
            + rec["output_size_bytes"] + rec["temp_size_bytes"]
        assert rec["devices"] == 4 and rec["mesh"] == "2x2"
    assert port["full"]["trace"] == {"depths": "full"}
    assert port["extra"]["trace"]["extrapolated_to"] == [3, 4]


def _close(a, b, rtol):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rtol)
                                            for k in a)
    return abs(a - b) <= rtol * max(abs(a), abs(b))


def test_variants_extrapolate_to_the_full_trace(sides):
    """A 3-layer, 4-microbatch train step counted from its depth-1/2 and
    2/3-microbatch variants agrees with its full trace: argument and
    output bytes exactly; flops, bytes and collective bytes (the same
    kinds) within 1e-3 and the peak of its storages within 10% (in a model this
    small the peak's live set is not quite affine in the depth; the
    layers repeat identical work,
    but DTensor's placement of the stacked gradients in the optimizer
    step adds a few hundred flops that grow faster than the depth: 5e-6
    of the flops and 3e-4 of the bytes here, a model whose optimizer
    step is a large share of the work). ``roofline.run.measure_cell`` reports the
    extrapolated counts."""
    port = sides[1]
    full, extra, roof = port["full"], port["extra"], port["roof"]
    for k in ("argument_size_bytes", "output_size_bytes"):
        assert extra[k] == full[k], k
    for k in ("flops", "matmul_flops", "bytes_accessed"):
        assert _close(extra[k], full[k], 1e-3), (k, extra[k], full[k])
    ce, cf = extra["collectives"], full["collectives"]
    assert _close(ce["total"], cf["total"], 1e-3), (ce, cf)
    assert {k for k in ce if ce[k]} == {k for k in cf if cf[k]}
    assert _close(extra["temp_size_bytes"], full["temp_size_bytes"], 0.1)
    assert full["flops"] > 0 and full["collectives"]["total"] > 0
    assert roof["hlo_flops_per_chip"] == extra["flops"]
    assert roof["collective_bytes_per_chip"] == \
        extra["collectives"]["total"]
    assert roof["compute_s_corr"] == roof["compute_s"]


def test_cli_one_full_width_cell():
    """``python -m repro_torch.launch.dryrun`` traces phi3's decode_32k at
    full width on a fake group of 256 ranks and exits 0 within 60 s."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "phi3-mini-3.8b", "--shape", "decode_32k",
                        "--mesh", "single"], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "1 cells traced, 0 failures" in r.stdout
    assert time.perf_counter() - t0 < 60
