"""Pod dry-run: trace every (architecture x input shape) cell on the
production meshes from one process and record its per-rank memory and
work (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step with XLA's SPMD
partitioner over 256 or 512 faked devices. Here the step runs once on
rank 0 of a ``fake`` process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``), on the production
``DeviceMesh`` (``repro_torch.launch.mesh``), under ``FakeTensorMode``:
every state and input leaf is a DTensor placed by the arch's plan
(``state_shardings`` / ``input_shardings``) whose local shard is a fake
tensor, so nothing is allocated and a plan that does not fit the mesh
(an uneven shard, an axis used twice) fails here, as XLA's compile does.
A collective on the fake group moves nothing and returns its output
buffer as it was allocated; the LM, GNN and recsys steps read no value
back.

Each record has the reference's keys, per rank:

* ``compile_s``: the seconds of the trace.
* ``flops``, ``bytes_accessed``: counted by
  ``repro_torch.roofline.solver.LocalWorkCounter`` beneath DTensor, on
  the local shards (a counter around DTensor would count the global
  ops); ``matmul_flops`` is the part ``FlopCounterMode`` counts.
* ``argument_size_bytes``: the local bytes of the state and inputs,
  exact.
* ``output_size_bytes``: the local bytes of the outputs that are not
  arguments updated in place (training updates params and optimizer
  state in place, decode the cache: the reference's donation).
* ``temp_size_bytes``: the peak of the storages the step allocates (the
  counter tracks each new storage until its last tensor goes), less the
  outputs; ``peak_bytes_per_device`` the sum of the three.
* ``collectives``: the bytes of the collectives the step issued, by kind
  (``repro_torch.roofline.analysis.collective_bytes``).

Attention takes the plain route (``backend="reference"``): the fake
tensors live on no card.

The ``rama-multicut`` cells run on real tensors (their solver ops depend
on the data): ``pd_round_*`` and ``mp_sweep_1m`` replicated, as the
reference runs them, their flops whole-problem flops; ``dist_pd`` runs
rank 0's block over the fake group, whose all-gather of the block
results gets a stand-in answer (every rank's slot filled with rank 0's
own contribution: the right shape and range) so what follows reads
values a real run could give.

Usage:
    python -m repro_torch.launch.dryrun                  # all cells, both
    python -m repro_torch.launch.dryrun --arch granite-34b --shape train_4k \\
        --mesh single                                    # one cell
    python -m repro_torch.launch.dryrun --out records.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.analysis import collective_bytes
from repro_torch.roofline.solver import LocalWorkCounter, loop_corrected
from repro_torch.sharding import Sharding, distribute, local_bytes, \
    local_shape
from repro_torch.tree import tree_leaves, tree_map

ASSIGNED = [
    "granite-34b", "gemma2-9b", "phi3-mini-3.8b", "llama4-scout-17b-a16e",
    "grok-1-314b", "dimenet", "egnn", "mace", "graphcast", "wide-deep",
]
ALL_ARCHS = ASSIGNED + ["rama-multicut"]


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A ``fake`` default process group of ``world`` ranks, as rank
    ``rank``; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool = False):
    """The production mesh over the current (fake) group, on the host."""
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _place(tree, shardings):
    """``tree`` as DTensors placed by the same-shaped tree of
    :class:`Sharding` s (each rank keeps its slice)."""
    flat = iter(tree_leaves(tree))
    placed = [distribute(next(flat), s) for s in _sharding_leaves(shardings)]
    it = iter(placed)
    return tree_map(lambda _: next(it), tree)


def _sharding_leaves(tree) -> list:
    if isinstance(tree, Sharding):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [s for t in tree for s in _sharding_leaves(t)]


def _state_shardings(arch, mesh, shape) -> list:
    """``arch.state_shardings`` in the step's argument order."""
    out = arch.state_shardings(mesh, shape)
    keys = {"lm": ("params", "opt", "cache"), "gnn": ("params", "opt"),
            "recsys": ("params", "opt")}[arch.family]
    return [out[k] for k in keys if k in out]


def _collect_state(arch, shape, mesh) -> list:
    """The cell's state in the step's argument order, as DTensors placed
    by :func:`_state_shardings`; call under a ``FakeTensorMode``. The
    optimizer state is ``init_opt_state`` of the placed params: its plan
    is theirs."""
    if arch.family == "recsys" and shape.kind == "retrieval":
        return []
    sh = _state_shardings(arch, mesh, shape)
    abstract = arch.abstract_params(shape) if arch.family == "gnn" \
        else arch.abstract_params()
    states = [_place(abstract, sh[0])]
    if len(sh) > 1 and isinstance(sh[1], tuple) and hasattr(sh[1], "mu"):
        states.append(arch.abstract_opt(shape, states[0])
                      if arch.family == "gnn"
                      else arch.abstract_opt(states[0]))
    if arch.family == "lm" and shape.kind == "decode":
        states.append(_place(arch.abstract_cache(shape), sh[-1]))
    return states


def input_specs(arch_id: str, shape_name: str) -> dict:
    """(shape, dtype) of every model input of a cell."""
    arch = get_arch(arch_id)
    return arch.input_specs(arch.shapes[shape_name])


def _storage_ids(tree) -> set:
    ids = set()
    for t in tree_leaves(tree):
        loc = t.to_local() if hasattr(t, "to_local") else t
        ids.add(loc.untyped_storage()._cdata)
    return ids


def _new_bytes(out, args) -> int:
    """Local bytes of the output leaves that are not argument storages
    (in-place updates are the reference's donated buffers)."""
    taken = _storage_ids(args)
    total = 0
    for t in tree_leaves(out):
        loc = t.to_local() if hasattr(t, "to_local") else t
        sid = loc.untyped_storage()._cdata
        if sid not in taken:
            taken.add(sid)
            total += loc.numel() * loc.element_size()
    return total


def _measure(step, args) -> dict:
    """Run ``step(*args)`` once under the counters: flops, bytes, the
    collectives, the peak of the storages it allocates."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core.dist import count_collective_bytes
    with count_collective_bytes() as sent, implicit_replication(), \
            LocalWorkCounter(external=args) as wc:
        out = step(*args)
    peak = wc.peak_bytes
    out_b = _new_bytes(out, args)
    return {"flops": float(wc.flops), "matmul_flops": float(wc.matmul_flops),
            "bytes_accessed": float(wc.bytes),
            "output_size_bytes": out_b,
            "temp_size_bytes": max(int(peak) - out_b, 0),
            "collectives": collective_bytes(wc.collectives, sent["bytes"])}


def _lm_step_args(arch, shape, states, ins):
    if shape.kind == "decode":
        # the fill is a host int in the port's decode; the last row
        ins = dict(ins, cache_len=shape.dims["seq_len"] - 1)
    return states + list(ins.values())


def _trace(arch, shape, mesh) -> dict:
    """One traced step of an LM, GNN or recsys cell, its state and inputs
    made and placed under a fresh ``FakeTensorMode``: the counts of
    :func:`_measure` and the argument bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        states = _collect_state(arch, shape, mesh)
        in_sh = arch.input_shardings(mesh, shape)
        ins = {k: distribute(v, in_sh[k])
               for k, v in arch.abstract_inputs(shape).items()}
        arg_b = local_bytes(states) + local_bytes(ins)
        if arch.family == "lm":
            step = arch.step_fn(shape, backend="reference")
            args = _lm_step_args(arch, shape, states, ins)
        elif arch.family == "recsys" and shape.kind == "retrieval":
            step, args = arch.step_fn(shape), list(ins.values())
        else:
            step, args = arch.step_fn(shape), states + list(ins.values())
        m = _measure(step, args)
    m["argument_size_bytes"] = arg_b
    return m


COUNTS = ("flops", "matmul_flops", "bytes_accessed")


def lm_depths(arch) -> tuple:
    """The depths of the LM depth variants: gemma2 alternates local and
    global layers, so its are 2 and 4 (the reference's roofline rule)."""
    return (2, 4) if arch.cfg.local_global_alternate else (1, 2)


def lm_variant(arch, shape, mesh, n_layers: int, k: int = 1):
    """``arch`` cut to ``n_layers`` and, for a train cell, to ``k`` of its
    microbatches: the global batch cut to k per-rank microbatches of the
    full step's size, so each is one of the full step's."""
    cfg = dataclasses.replace(arch.cfg, n_layers=n_layers)
    if shape.kind != "train":
        return dataclasses.replace(arch, cfg=cfg), shape
    _, rows, shards = arch.microbatches(shape.dims["global_batch"], mesh)
    dims = dict(shape.dims, global_batch=shards * rows * k)
    return (dataclasses.replace(arch, cfg=cfg, grad_accum=k),
            dataclasses.replace(shape, dims=dims))


def _affine(x1, x2, t):
    """``loop_corrected`` at t steps past x1 (x1 + t (x2 - x1)), per key
    for dicts."""
    if isinstance(x1, dict):
        return {k: _affine(x1[k], x2[k], t) for k in x1}
    return loop_corrected(x1, x2, 1 + t)


def _lm_extrapolated(arch, shape, mesh) -> tuple[dict, dict]:
    """An LM cell's counts from its depth (and microbatch) variants: the
    layer loop and the microbatch loop repeat identical work, so flops,
    bytes and collective bytes are affine in the depth and in the number
    of microbatches (bilinear together, exactly), and the peak of the
    allocated storages is affine in the depth. Traces at depths
    :func:`lm_depths`, and for a train step with more than one microbatch
    at 2 and 3 of them, all on the accumulating path."""
    L = arch.cfg.n_layers
    d1, d2 = lm_depths(arch)
    ga = arch.microbatches(shape.dims["global_batch"], mesh)[0] \
        if shape.kind == "train" else 1
    ks = (2, 3) if ga > 1 else (1,)
    grid = {(d, k): _trace(*lm_variant(arch, shape, mesh, d, k), mesh)
            for d in (d1, d2) for k in ks}
    tL = (L - d1) / (d2 - d1)
    keys = COUNTS + ("collectives",)
    rows = []
    for k in ks:
        rows.append({key: _affine(grid[d1, k][key], grid[d2, k][key], tL)
                     for key in keys + ("temp_size_bytes",
                                        "output_size_bytes")})
    out = rows[0]
    if len(ks) > 1:
        tk = (ga - ks[0]) / (ks[1] - ks[0])
        for key in keys:
            out[key] = _affine(rows[0][key], rows[1][key], tk)
    out["collectives"] = {k: int(round(v))
                          for k, v in out["collectives"].items()}
    for key in ("temp_size_bytes", "output_size_bytes"):
        out[key] = int(round(out[key]))
    return out, {"depths": [d1, d2], "microbatches": list(ks),
                 "extrapolated_to": [L, ga]}


def _arguments(arch, shape, mesh) -> int:
    """The exact local bytes of a cell's state and inputs at full size
    (made under a fresh ``FakeTensorMode``; nothing runs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        states = _collect_state(arch, shape, mesh)
        in_sh = arch.input_shardings(mesh, shape)
        return local_bytes(states) + sum(
            math.prod(local_shape(mesh, in_sh[k].spec, v.shape))
            * v.dtype.itemsize for k, v in arch.input_specs(shape).items())


def dryrun_cell(arch_id: str, shape_name: str, mesh, *, verbose=True,
                arch=None, shape=None, full_depth: bool = False):
    """Trace one (arch x shape) cell on rank 0 of ``mesh`` (over a fake
    group). Returns the record. An LM cell deeper than its depth variants
    is counted from them (:func:`_lm_extrapolated`; ``trace`` says how)
    unless ``full_depth``; its argument bytes are the full cell's either
    way. ``arch`` and ``shape`` override the registry's (a reduced
    variant under the same names)."""
    arch = arch or get_arch(arch_id)
    if hasattr(arch, "for_mesh"):
        arch = arch.for_mesh(mesh)
    shape = shape or arch.shapes[shape_name]
    t0 = time.perf_counter()
    how = {"depths": "full"}
    if arch.family == "multicut":
        m = _dryrun_multicut(arch, shape, mesh)
    elif arch.family == "lm" and not full_depth \
            and arch.cfg.n_layers > lm_depths(arch)[1]:
        m, how = _lm_extrapolated(arch, shape, mesh)
        m["argument_size_bytes"] = _arguments(arch, shape, mesh)
    else:
        m = _trace(arch, shape, mesh)
    rec = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "devices": mesh.size(),
        "compile_s": round(time.perf_counter() - t0, 1),
        "flops": float(m["flops"]),
        "matmul_flops": float(m["matmul_flops"]),
        "bytes_accessed": float(m["bytes_accessed"]),
        "argument_size_bytes": int(m["argument_size_bytes"]),
        "output_size_bytes": int(m["output_size_bytes"]),
        "temp_size_bytes": int(m["temp_size_bytes"]),
        "peak_bytes_per_device": int(m["argument_size_bytes"]
                                     + m["output_size_bytes"]
                                     + m["temp_size_bytes"]),
        "collectives": m["collectives"],
        "trace": how,
    }
    if verbose:
        print(f"  [{rec['mesh']}] {arch_id}/{shape_name}: "
              f"trace {rec['compile_s']}s, {rec['flops']:.3e} flops, "
              f"args {rec['argument_size_bytes'] / 2**30:.2f} GiB, "
              f"temp {rec['temp_size_bytes'] / 2**30:.2f} GiB, "
              f"collectives {rec['collectives']['total'] / 2**20:.1f} MiB "
              f"(per rank)", flush=True)
    return rec


# ---------------------------------------------------------------------------
# rama-multicut: real tensors
# ---------------------------------------------------------------------------

def multicut_inputs(arch, shape, mesh) -> dict:
    """Real inputs of a rama-multicut cell from seed 0, on the host: a
    grid of n_nodes padded to n_edges for a round; random triangles over
    random costs for MP; for dist_pd, that grid as every rank's block and
    random boundary costs."""
    from repro_torch.core.graph import grid_instance
    d = shape.dims
    gen = torch.Generator().manual_seed(0)

    def grid(n, e):
        side = int(round(n ** 0.5))
        return grid_instance(side, side, seed=0, pad_edges=e, device="cpu")

    if shape.kind == "solver":
        return dict(zip(("u", "v", "cost", "edge_valid", "node_valid"),
                        grid(d["n_nodes"], d["n_edges"])))
    if shape.kind == "mp":
        E, T = d["n_edges"], d["n_triangles"]
        return {"cost": torch.randn(E, generator=gen),
                "edge_valid": torch.ones(E, dtype=torch.bool),
                "tri": torch.randint(0, E, (T, 3), generator=gen,
                                     dtype=torch.int32),
                "tri_valid": torch.ones(T, dtype=torch.bool)}
    specs = arch.dist_inputs(mesh, shape)
    nb = specs["u"].shape[0]
    blk = grid(d["blk_nodes"], d["blk_edges"])
    out = {k: t[None].expand((nb,) + tuple(t.shape)).contiguous()
           for k, t in zip(("u", "v", "cost", "edge_valid", "node_valid"),
                           blk)}
    out["boundary_cost"] = torch.randn(d["boundary_edges"], generator=gen)
    return out


@contextlib.contextmanager
def _stand_in_gathers():
    """On a fake group, every all-gather of ``repro_torch.core.dist``
    returns this rank's contribution in every rank's slot (the fake
    backend leaves the output as allocated)."""
    from repro_torch.core import dist as cdist
    real = cdist._gather_single

    def gather(out, w, group=None):
        real(out, w, group=group)
        out.copy_(w.expand((out.shape[0] // w.shape[0],) + tuple(w.shape))
                  .reshape(out.shape))

    cdist._gather_single = gather
    try:
        yield
    finally:
        cdist._gather_single = real


def _dryrun_multicut(arch, shape, mesh) -> dict:
    ins = multicut_inputs(arch, shape, mesh)
    step = arch.step_fn(shape)
    if shape.kind == "dist":
        in_sh = arch.input_shardings(mesh, shape)
        arg_b = sum(math.prod(local_shape(mesh, in_sh[k].spec, v.shape))
                    * v.element_size() for k, v in ins.items())
        with _stand_in_gathers():
            m = _measure(step, list(ins.values()))
    else:
        arg_b = local_bytes(ins)
        m = _measure(step, list(ins.values()))
    m["argument_size_bytes"] = arg_b
    return m


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def iter_cells(arch_ids=None, shape_names=None):
    for aid in (arch_ids or ALL_ARCHS):
        arch = get_arch(aid)
        for sname in (shape_names or list(arch.shapes)):
            if sname in arch.shapes:
                yield aid, sname


MESHES = {"single": ("single-pod 16x16", 256, False),
          "multi": ("multi-pod 2x16x16", 512, True)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None, help="write records JSON here")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    names = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    arch_ids = [args.arch] if args.arch else None
    shapes = [args.shape] if args.shape else None
    records, failures = [], []
    t0 = time.perf_counter()
    for name in names:
        label, world, multi = MESHES[name]
        with fake_group(world):
            mesh = production_mesh(multi)
            print(f"=== {label} ({world} ranks, fake group) ===", flush=True)
            for aid, sname in iter_cells(arch_ids, shapes):
                try:
                    records.append(dryrun_cell(aid, sname, mesh))
                except Exception as e:  # noqa: BLE001 (report every cell)
                    failures.append((label, aid, sname, repr(e)))
                    print(f"  FAIL {aid}/{sname}: {e}", flush=True)
                    traceback.print_exc(limit=3)
            del mesh
    print(f"\n{len(records)} cells traced, {len(failures)} failures, "
          f"{time.perf_counter() - t0:.1f} s")
    for f in failures:
        print("  FAILED:", *f[:3])
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(records, fh, indent=1)
        print("wrote", args.out)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
