#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, in order; any failure exits nonzero with no ``ok`` line:

1. Environment: the card's name and power limit, torch and CUDA versions;
   builds both kernels from ``src/repro_torch/csrc`` (one nvcc each, in
   parallel) and prints the build seconds.
2. Kernels against their plain PyTorch versions on the card, at the
   listed shapes: ``triangle_mp`` must be bitwise equal, ``cycle_intersect``
   exactly equal. Times are CUDA-event medians.
3. The main path at full size: ``api.solve`` with the default preset on
   ``grid_instance(512, 1024)`` (524 288 nodes, 2 609 161 edges), through
   both hand kernels (their launch counters are zeroed just before and read
   just after), then the same solve with ``backend="reference"``: labels,
   rounds, histories, objective and lower bound must be equal. Checks the
   lower bound ≤ objective, the labels form a partition, and the objective
   against a float64 recount on the host. Prints wall time (median of 3
   after a warm-up), rounds, host syncs per solve and peak memory; then
   holds each kernel against its plain version at every shape the main
   path gave it.
4. Card against CPU: ``grid_instance(96, 96, seed=1)`` solved on both.
   Labels must be equal and objective / lower bound within 1e-5 relative;
   if the labels differ, the first round where the runs part is printed.

Prints the ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Writes the
full record to ``chiprun_out/chip_smoke.json``.

``--rehearse`` runs the same phases on the CPU at small sizes (a 20×20
main-path grid, a 17×17 card-vs-CPU grid), with each kernel wrapper running
its plain version, to find wrong paths and shapes before a run on the card;
it prints no result and exits 3.

The smoke drives one card: it keeps only the first of the visible devices.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

# one card: the first visible one, numbered as nvidia-smi numbers it
os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
CARD = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
os.environ["CUDA_VISIBLE_DEVICES"] = CARD

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.core import graph  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cycle_intersect import ops as isect_ops  # noqa: E402
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref  # noqa: E402,E501
from repro_torch.kernels.triangle_mp import ops as sweep_ops  # noqa: E402
from repro_torch.kernels.triangle_mp.ref import mp_sweep_ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SWEEP_FLOPS = 50                # per triangle: 6 steps x ~8 ops
REPS = 20
DEV = torch.device("cuda")      # --rehearse switches to the CPU
GRIDS = {"card": ((512, 1024), (96, 96)),    # (main path, card vs CPU)
         "rehearse": ((20, 20), (17, 17))}
PORT = str(ROOT / "src" / "repro_torch")

KERNELS = {
    "triangle_mp": dict(
        source="src/repro_torch/csrc/triangle_mp.cu",
        replaces="src/repro/kernels/triangle_mp/kernel.py:51"),
    "cycle_intersect": dict(
        source="src/repro_torch/csrc/cycle_intersect.cu",
        replaces="src/repro/kernels/cycle_intersect/kernel.py:98"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", CARD, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"{torch.cuda.get_device_name(0)}, power limit not readable"


def sync():
    if DEV.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps=REPS, warmup=3) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    if DEV.type != "cuda":          # rehearsal: no device time exists
        return float("nan")
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Kernel checks and timings
# ---------------------------------------------------------------------------

def sweep_case(T: int, gen) -> dict:
    x = torch.randn(T, 3, device=DEV, generator=gen) * 3.0
    n0 = sweep_ops.launches
    got = sweep_ops.mp_sweep(x)
    want = mp_sweep_ref(x)
    sync()
    check(sweep_ops.launches == n0 + (DEV.type == "cuda"),
          f"triangle_mp T={T}: no launch")
    bitwise = bool(torch.equal(got.view(torch.int32),
                               want.view(torch.int32)))
    err = float((got - want).abs().max()) if T else 0.0
    check(bitwise, f"triangle_mp T={T}: not bitwise equal (max err {err})")
    bytes_moved = 24 * T
    ops = SWEEP_FLOPS * T
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(shape=[T, 3], bitwise=bitwise, max_abs_err=err,
                kernel_ms=cuda_ms(lambda: sweep_ops.mp_sweep(x)),
                plain_ms=cuda_ms(lambda: mp_sweep_ref(x)),
                library_ms=None, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def sorted_rows(R: int, W: int, n: int, gen) -> torch.Tensor:
    """(R, W) rows of sorted ids < n with random degree, padded with the
    sentinel n (the CSR window layout); about a tenth of the rows empty."""
    x = torch.sort(torch.randint(0, n, (R, W), device=DEV,
                                 dtype=torch.int32, generator=gen), 1).values
    deg = torch.randint(0, W + 1, (R, 1), device=DEV, generator=gen)
    deg = torch.where(torch.rand(R, 1, device=DEV, generator=gen) < 0.1,
                      torch.zeros_like(deg), deg)
    ar = torch.arange(W, device=DEV)
    return torch.where(ar < deg, x, torch.full_like(x, n)).contiguous()


def intersect_case(R: int, W: int, Wj: int, gen, ci=None) -> dict:
    n = 2 * max(W, Wj) + 8
    ci = sorted_rows(R, W, n, gen) if ci is None else ci
    cj = sorted_rows(R, Wj, n, gen)
    n0 = isect_ops.launches
    got = isect_ops.intersect_rows(ci, cj)
    want = intersect_rows_ref(ci, cj)
    sync()
    check(isect_ops.launches == n0 + (DEV.type == "cuda"),
          f"cycle_intersect {R, W, Wj}: no launch")
    equal = bool(torch.equal(got, want))
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(equal, f"cycle_intersect {(R, W, Wj)}: not equal (max err {err})")
    bytes_moved = 4 * (2 * R * W + R * Wj)
    # data-dependent work: one upper-bound search of ceil(log2(Wj + 1))
    # compares per element (counted as 2 ops each: compare + select)
    ops = 2 * R * W * int(np.ceil(np.log2(Wj + 1)))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3

    def library():      # the search half only: no hit test, no -1
        torch.searchsorted(cj, ci, right=True)

    return dict(shape=[[R, W], [R, Wj]], equal=equal, max_abs_err=err,
                matches=int((got >= 0).sum()),
                kernel_ms=cuda_ms(lambda: isect_ops.intersect_rows(ci, cj)),
                plain_ms=cuda_ms(lambda: intersect_rows_ref(ci, cj)),
                library_ms=cuda_ms(library), bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(gen, small: bool) -> dict:
    cases = {"triangle_mp": [], "cycle_intersect": []}
    big = 65536 if not small else 512
    for T in ((1 << 20, 1_000_003) if not small else (4096, 4099)):
        cases["triangle_mp"].append(sweep_case(T, gen))
    for R, W, Wj in [(256, 16, 16), (256, 128, 128), (1024, 128, 128),
                     (1024, 4, 128), (300, 37, 129), (big, 128, 128),
                     (9, 1, 1), (8, 1, 20000)]:
        cases["cycle_intersect"].append(intersect_case(R, W, Wj, gen))
    # an unsorted ci (the chord test's fan) and all-empty rows
    fan = torch.randint(0, 264, (1024, 4), device=DEV, dtype=torch.int32,
                        generator=gen)
    cases["cycle_intersect"].append(intersect_case(1024, 4, 128, gen,
                                                   ci=fan))
    empty = torch.full((512, 64), 136, device=DEV, dtype=torch.int32)
    cases["cycle_intersect"].append(intersect_case(512, 64, 64, gen,
                                                   ci=empty))
    for name, rows in cases.items():
        for c in rows:
            log(f"  {name} {c['shape']}: kernel {c['kernel_ms']:.4f} ms, "
                f"plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.5f} "
                f"ms, err {c['max_abs_err']}")
    return cases


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def reset_counters():
    sweep_ops.launches = 0
    sweep_ops.shapes.clear()
    isect_ops.launches = 0
    isect_ops.shapes.clear()


def timed_solve(inst, **kw):
    sync()
    t0 = time.perf_counter()
    res = api.solve(inst, device=DEV, **kw)
    sync()
    return res, time.perf_counter() - t0


def host(res) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in res._asdict().items()}


def same_result(a: dict, b: dict) -> list:
    return [k for k in a if not np.array_equal(a[k], b[k])]


def check_solution(inst, r: dict, what: str):
    labels = r["labels"]
    rounds = int(r["rounds"])
    k = int(r["n_clusters"][rounds - 1])
    check(np.isfinite(r["objective"]) and np.isfinite(r["lower_bound"]),
          f"{what}: non-finite objective/lower bound")
    check(float(r["lower_bound"]) <= float(r["objective"]) + 1e-3,
          f"{what}: lower bound {r['lower_bound']} > objective "
          f"{r['objective']}")
    check(labels.min() == 0 and labels.max() == k - 1
          and len(np.unique(labels)) == k,
          f"{what}: labels are not a partition into {k} clusters")
    # independent recount of the objective on the host, in float64
    u = inst.u.cpu().numpy()
    v = inst.v.cpu().numpy()
    ev = inst.edge_valid.cpu().numpy()
    c = inst.cost.cpu().numpy().astype(np.float64)
    obj64 = float(c[ev & (labels[u] != labels[v])].sum())
    rel = abs(obj64 - float(r["objective"])) / max(1.0, abs(obj64))
    check(rel < 1e-4, f"{what}: objective {r['objective']} vs host recount "
          f"{obj64}")
    return obj64


def count_syncs(fn) -> Counter:
    """Synchronising CUDA calls during ``fn``, as torch's sync debug mode
    reports them, by the innermost function of the port that made each
    (by the innermost frame where no function of the port is on the
    stack)."""
    sites = Counter()
    if DEV.type != "cuda":
        fn()
        return sites

    def note(message, *_):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]
        own = [f for f in stack if f.filename.startswith(PORT)]
        f = own[-1] if own else stack[-1]
        where = f"{Path(f.filename).name}:{f.name}" if own else \
            f"outside the port, {Path(f.filename).name}:{f.lineno}"
        sites[where] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    return sites


def profile_solve(inst) -> dict:
    """One main-path solve under torch.profiler: device busy time (the sum
    of the device-side kernel and copy events), each round phase's host and
    device milliseconds (the solver's ``repro.*`` ranges, summed over
    rounds), device time per launch of each hand kernel, and the kernels
    that take the most device time."""
    if DEV.type != "cuda":
        return {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        api.solve(inst, device=DEV)
        sync()
    phases = {}
    by_kernel = {}
    for e in prof.events():
        dur = e.time_range.elapsed_us()
        if e.key.startswith("repro."):
            side = "device_ms" if e.device_type == DeviceType.CUDA \
                else "host_ms"
            ph = phases.setdefault(e.key, {"host_ms": 0.0, "device_ms": 0.0})
            ph[side] += dur / 1e3
        elif e.device_type == DeviceType.CUDA:
            n, us = by_kernel.get(e.key, (0, 0.0))
            by_kernel[e.key] = (n + 1, us + dur)
    busy_us = sum(us for _, us in by_kernel.values())
    kern = {}
    for name, sym in (("triangle_mp", "triangle_mp_sweep_kernel"),
                      ("cycle_intersect", "cycle_intersect_kernel")):
        n = sum(c for k, (c, _) in by_kernel.items() if sym in k)
        us = sum(t for k, (_, t) in by_kernel.items() if sym in k)
        kern[name] = dict(launches=n, device_us_total=us,
                          device_us_per_launch=us / n if n else None)
    top = sorted(by_kernel.items(), key=lambda kv: kv[1][1],
                 reverse=True)[:12]
    return dict(device_busy_ms=busy_us / 1e3, phases=phases, kernels=kern,
                device_launches=sum(c for c, _ in by_kernel.values()),
                top_device_kernels=[dict(name=k[:100], count=c,
                                         device_ms=us / 1e3)
                                    for k, (c, us) in top])


def phase_main(h: int, w: int, max_neg: int) -> dict:
    E = (h * (w - 1) + (h - 1) * w + h * (w - 4) + (h - 4) * w
         + (h - 3) * (w - 3))
    t0 = time.perf_counter()
    inst = graph.grid_instance(h, w, seed=0, pad_edges=E + 4 * max_neg,
                               device=DEV)
    sync()
    log(f"  instance {h}x{w}: {inst.num_nodes} nodes, "
        f"{int(inst.edge_valid.sum())} edges (+{inst.num_edges - E} chord "
        f"slots), built in {time.perf_counter() - t0:.2f} s")

    if DEV.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counters()
    res, first_s = timed_solve(inst)                 # the main path
    launches = {"triangle_mp": sweep_ops.launches,
                "cycle_intersect": isect_ops.launches}
    main_shapes = {"triangle_mp": dict(sweep_ops.shapes),
                   "cycle_intersect": dict(isect_ops.shapes)}
    peak = torch.cuda.max_memory_allocated() if DEV.type == "cuda" else 0
    log(f"  default solve: {first_s:.3f} s (first call), launches "
        f"{launches}")
    check(DEV.type != "cuda" or all(n > 0 for n in launches.values()),
          f"main path did not launch every kernel: {launches}")
    r = host(res)

    reset_counters()
    ref, ref_s = timed_solve(inst, backend="reference")
    check(sweep_ops.launches == 0 and isect_ops.launches == 0,
          "backend='reference' launched a kernel")
    rr = host(ref)
    diff = same_result(r, rr)
    check(not diff, f"kernel solve != reference solve in {diff}")
    obj64 = check_solution(inst, r, "main path")

    walls = [timed_solve(inst)[1] for _ in range(3)]
    sync_sites = count_syncs(lambda: api.solve(inst, device=DEV))
    syncs = sum(sync_sites.values())
    prof = profile_solve(inst)
    out = dict(
        instance=dict(h=h, w=w, nodes=inst.num_nodes, edges=E,
                      pad_edges=inst.num_edges),
        rounds=int(r["rounds"]), objective=float(r["objective"]),
        objective_host_f64=obj64, lower_bound=float(r["lower_bound"]),
        n_contracted=r["n_contracted"].tolist(),
        n_clusters=r["n_clusters"].tolist(),
        wall_s_median=statistics.median(walls), wall_s=walls,
        first_call_s=first_s, reference_backend_s=ref_s,
        host_syncs=syncs, host_sync_sites=dict(sync_sites.most_common()),
        peak_bytes=peak, launches=launches, profile=prof,
        shapes={k: {str(s): n for s, n in v.items()}
                for k, v in main_shapes.items()})
    log(f"  wall {out['wall_s_median']:.3f} s (median of 3), rounds "
        f"{out['rounds']}, objective {out['objective']}, lower bound "
        f"{out['lower_bound']}, host syncs {syncs} "
        f"{out['host_sync_sites']}, peak {peak / 2**20:.1f} MiB")
    if prof:
        busy = prof["device_busy_ms"] / 1e3
        log(f"  profiled solve: device busy {busy:.3f} s of "
            f"{out['wall_s_median']:.3f} s wall (idle share "
            f"{1 - busy / out['wall_s_median']:.3f}), "
            f"{prof['device_launches']} device events; phases "
            f"{prof['phases']}; kernels {prof['kernels']}")
    out["main_shapes"] = main_shapes
    return out


def first_divergence(a: dict, b: dict) -> int | None:
    for i, (x, y) in enumerate(zip(a["n_contracted"], b["n_contracted"])):
        if x != y or a["n_clusters"][i] != b["n_clusters"][i]:
            return i
    return None


def phase_cpu(h: int, w: int) -> dict:
    gpu = host(api.solve(graph.grid_instance(h, w, seed=1, device=DEV),
                         device=DEV))
    cpu = host(api.solve(graph.grid_instance(h, w, seed=1, device="cpu"),
                         device="cpu"))
    labels_equal = bool(np.array_equal(gpu["labels"], cpu["labels"]))
    out = dict(instance=[h, w], labels_equal=labels_equal,
               rounds=[int(gpu["rounds"]), int(cpu["rounds"])],
               objective=[float(gpu["objective"]), float(cpu["objective"])],
               lower_bound=[float(gpu["lower_bound"]),
                            float(cpu["lower_bound"])],
               integer_fields_equal=not same_result(
                   {k: gpu[k] for k in ("labels", "rounds", "n_contracted",
                                        "n_clusters")},
                   {k: cpu[k] for k in ("labels", "rounds", "n_contracted",
                                        "n_clusters")}))
    if labels_equal:
        for f in ("objective", "lower_bound"):
            g, c = float(gpu[f]), float(cpu[f])
            check(abs(g - c) <= 1e-5 * max(1.0, abs(c)),
                  f"card vs CPU {f}: {g} vs {c}")
        check(out["integer_fields_equal"], "card vs CPU histories differ")
    else:
        out["first_divergent_round"] = first_divergence(gpu, cpu)
        log(f"  card and CPU labels differ; first divergent round "
            f"{out['first_divergent_round']}")
    log(f"  card vs CPU {h}x{w}: labels equal {labels_equal}, objective "
        f"{out['objective']}, lower bound {out['lower_bound']}")
    return out


def main_path_cases(main: dict, gen) -> dict:
    """Hold each kernel against its plain version at every shape the main
    path gave it (fresh data of those shapes)."""
    out = {"triangle_mp": [], "cycle_intersect": []}
    for T in sorted(main["main_shapes"]["triangle_mp"]):
        out["triangle_mp"].append(sweep_case(T, gen))
    for (R, W, Wj) in sorted(main["main_shapes"]["cycle_intersect"]):
        out["cycle_intersect"].append(intersect_case(R, W, Wj, gen))
    return out


def kernel_line(cases: dict, main_cases: dict, main: dict) -> dict:
    rows = []
    for name, meta in KERNELS.items():
        shapes = main["main_shapes"][name]
        top = max(shapes, key=shapes.get)       # most launched shape
        key = [top, 3] if name == "triangle_mp" else \
            [[top[0], top[1]], [top[0], top[2]]]
        head = next(c for c in main_cases[name] if c["shape"] == key)
        every = cases[name] + main_cases[name]
        rows.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=main["launches"][name],
            max_abs_err=max(c["max_abs_err"] for c in every),
            shape=head["shape"], ms=head["kernel_ms"],
            kernel_ms=head["kernel_ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            library_note=(None if name == "triangle_mp" else
                          "torch.searchsorted: the search half only"),
            device_us_per_launch=main.get("profile", {}).get(
                "kernels", {}).get(name, {}).get("device_us_per_launch"),
            cases=every))
    return {"kernels": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                        "chip_smoke.json"))
    p.add_argument("--rehearse", action="store_true",
                   help="run the phases on the CPU at small sizes; prints "
                        "no result and exits 3")
    args = p.parse_args(argv)
    main_grid, cpu_grid = GRIDS["rehearse" if args.rehearse else "card"]
    if args.rehearse:
        global DEV
        DEV = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    elif torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} cards visible; "
              f"this script drives one", file=sys.stderr)
        return 2
    card = nvidia_smi() if DEV.type == "cuda" else "rehearsal on the CPU"
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, device=str(DEV))
    try:
        log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, Python {sys.version.split()[0]}")
        record["build_s"] = _build.build_all() if DEV.type == "cuda" \
            else 0.0
        log(f"  built kernels in {record['build_s']:.2f} s")
        for name, text in _build.build_log.items():
            regs = [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
            log(f"  {name}: " + " | ".join(regs))
        gen = torch.Generator(device=DEV).manual_seed(0)
        log("phase 2: kernels against their plain versions")
        cases = phase_kernels(gen, small=args.rehearse)
        log("phase 3: main path")
        main_rec = phase_main(*main_grid, api.SolverConfig().max_neg)
        main_cases = main_path_cases(main_rec, gen)
        line = kernel_line(cases, main_cases, main_rec)
        del main_rec["main_shapes"]
        record["main_path"] = main_rec
        log("phase 4: card against CPU")
        record["cpu_parity"] = phase_cpu(*cpu_grid)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    if args.rehearse:
        print("chip_smoke: rehearsal finished on the CPU; no result",
              file=sys.stderr)
        return 3
    record.update(line)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
