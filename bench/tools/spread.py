#!/usr/bin/env python3
"""Run one cell several times, one process a run as a check does, and
print each run's metrics and the spread of each metric.

    python3 bench/tools/spread.py --workload cityscapes.pd \
        --seeds 3000000001 3000000002 3000000003 --seconds 51 [--trace 1] \
        [--sets 2] [--out chiprun_out/spread]

A set runs every seed once, in order; ``--sets 2`` runs the seeds again.
A spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median. Each
run's standard output and error go to ``--out``; the summary is the last
line of standard output.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default="chiprun_out/spread")
    args = ap.parse_args()
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    sets = []
    for s in range(args.sets):
        runs = []
        for seed in args.seeds:
            tag = f"{args.workload}.t{args.trace}.set{s}.{seed}"
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "bench/run.py", "--workload", args.workload,
                 "--seed", str(seed), "--seconds", str(args.seconds),
                 "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            (out / f"{tag}.out").write_text(p.stdout)
            (out / f"{tag}.err").write_text(p.stderr)
            line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() \
                else ""
            try:
                res = json.loads(line)
            except json.JSONDecodeError:
                res = None
            row = dict(seed=seed, rc=p.returncode, wall_s=wall,
                       correct=res and res["correct"],
                       metrics={k: v["value"] for k, v in
                                res["metrics"].items()} if res else None,
                       checks={k: v["value"] for k, v in
                               res["checks"].items()} if res else None,
                       device={k: res["device"].get(k) for k in
                               ("busy_s", "window_s", "memory_peak_bytes")}
                       if res else None)
            print(json.dumps(row), flush=True)
            if res is None:
                print(p.stderr[-3000:], flush=True)
            runs.append(row)
        sets.append(runs)
    summary = {}
    for i, runs in enumerate(sets):
        names = {k for r in runs if r["metrics"] for k in r["metrics"]}
        summary[f"set{i}"] = {
            k: dict(median=statistics.median(v), spread=spread(v), n=len(v))
            for k in sorted(names)
            for v in [[r["metrics"][k] for r in runs
                       if r["metrics"] and k in r["metrics"]]]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
