"""One run of one cell: set-up, the measured window, the answers judged
against the plain reference, the metrics read. ``bench/run.py`` calls
:func:`run_cell` after its look for a card; the tests call it on the CPU
with the program broken underneath.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

from ramabench import manifest, profiling, traffic as traffic_gen
from ramabench.capture import Capture
from ramabench.loops import SolveLoop, sync


@dataclass
class Run:
    """What the metric readers see (``bench/metrics/<name>.py``)."""
    cell: dict
    config: dict
    plan: object
    traced: bool
    setup_s: float = math.nan
    window_s: float = math.nan
    records: list = field(default_factory=list)
    trace: dict | None = None
    capture: Capture | None = None
    syncs_per_solve: int | None = None

    @property
    def done_in_window(self) -> list:
        return [r for r in self.records if r.get("host") is not None]


def host_answer(res) -> dict:
    """The program's answer, copied to the host."""
    rounds = int(res.rounds)
    k = int(res.n_clusters[rounds - 1]) if rounds else \
        int(res.labels.shape[0])
    return dict(labels=res.labels.cpu().numpy(),
                objective=float(res.objective),
                lower_bound=float(res.lower_bound), n_clusters=k,
                rounds=rounds)


def judge(run: Run, ref, limits: dict) -> dict:
    """Name -> value of each number the limits name, over every answer:
    counts summed, the others at their worst."""
    values = {k: 0.0 for k in limits}
    for rec in run.records:
        if rec.get("host") is None:
            values["unanswered"] = values.get("unanswered", 0) + 1
            continue
        inst = run.plan.host[rec["index"]]
        nums = ref.judge(inst, rec["host"])
        rec["recount"] = nums.pop("recount", None)
        rec["trivial"] = nums.pop("trivial")
        cyc = rec.get("cycles")
        if cyc is not None:
            nums["cycle_faults"] = ref.cycle_faults(inst, cyc)
            nums["tri_inv"] = ref.tri_inv(cyc)
        elif "cycle_faults" in limits:
            nums["cycle_faults"] = 1
        for k in limits:
            v = nums.get(k, math.inf)
            values[k] = values[k] + v if k.endswith("faults") else \
                max(values[k], v)
    return values


def run_cell(cell: dict, config: dict, traffic: dict, limits: dict,
             seed: int, seconds: float, traced: bool, device, t_start: float,
             metrics: list[dict], clock=time.perf_counter, cost=None):
    """Returns (the result's line as a dict, the compared numbers as
    name -> (value, limit), the :class:`Run`)."""
    import torch
    from repro_torch.core.solver import SolverConfig

    plan = traffic_gen.make_plan(config, traffic, seed,
                                 SolverConfig().max_neg)
    run = Run(cell=cell, config=config, plan=plan, traced=traced)
    run.capture = capture = Capture(traced).install()
    loop = SolveLoop(config, plan, device, capture, cost=cost)
    try:
        if device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build_all(["triangle_mp", "cycle_intersect"])
        loop.setup()
        if traced:
            run.syncs_per_solve = profiling.count_syncs(
                lambda: loop.solve(0, note_cycles=False)) \
                if device.type == "cuda" else None
        sync(device)
        run.setup_s = clock() - t_start
        if traced:
            run.trace = _traced_window(loop, seconds, capture, device)
        else:
            loop.window(seconds)
        run.window_s = loop.window_s
        run.records = loop.records
        sync(device)
        peak = torch.cuda.max_memory_allocated(device) \
            if device.type == "cuda" else 0
        for rec in run.records:
            res = rec.pop("answer", None)
            rec["host"] = None if res is None else host_answer(res)
            cyc = rec.get("cycles")
            if cyc is not None:
                rec["cycles"] = {k: v.cpu().numpy() if hasattr(v, "cpu")
                                 else v for k, v in cyc.items()}
        if traced:
            _host_capture(capture)
    finally:
        capture.uninstall()
        loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = manifest.reference(config["reference"])
    values = judge(run, ref, limits)
    failed = sum(1 for r in run.records if r.get("host") is None)
    checks = {k: (values[k], limits[k]) for k in limits}
    if "unanswered" in values and "unanswered" not in checks:
        checks["unanswered"] = (values["unanswered"], 0.0)
    correct = bool(run.done_in_window) and failed == 0 and all(
        v <= lim for v, lim in checks.values())

    out_metrics = {}
    for m in metrics:
        v = manifest.reader(m["name"])(run)
        if v is not None:
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
    result = {"correct": correct, "attempted": len(run.records),
              "failed": failed, "metrics": out_metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    return result, checks, run


def _traced_window(loop, seconds, capture, device) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        capture.recording = True
        try:
            with record_function(profiling.WINDOW):
                loop.window(seconds)
                sync(device)
        finally:
            capture.recording = False
    t0 = time.perf_counter()
    out = profiling.reduce_trace(prof)
    out["reduce_s"] = time.perf_counter() - t0
    return out


def _host_capture(capture: Capture) -> None:
    """The traced run's notes, to the host: triangles as numpy, counts as
    numbers."""
    capture.mp_calls = [(t.cpu().numpy(), tv.cpu().numpy(), it)
                        for t, tv, it in capture.mp_calls]
    capture.contractions = [tuple(int(x) for x in c)
                            for c in capture.contractions]


def checks_text(checks: dict) -> list[str]:
    return [f"{k} {_num(v)} limit {_num(lim)}"
            for k, (v, lim) in checks.items()]


def _num(x: float):
    x = float(x)
    if math.isfinite(x) and x == int(x) and abs(x) < 2**53:
        return int(x)
    return x if math.isfinite(x) else str(x)


def checks_json(checks: dict) -> dict:
    return {k: {"value": _num(v), "limit": _num(lim)}
            for k, (v, lim) in checks.items()}
