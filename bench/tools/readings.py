#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 bench/tools/readings.py --workload cityscapes.pd \
        --seeds 11 12 13 --control-seeds 21 22 23 --seconds 1 \
        --fault-seeds 31 32 33

For each ``--seeds`` seed, one run of the cell (the program as the
configuration states, ``--seconds`` of window); for each
``--control-seeds`` seed, the reference in the program's place in
bfloat16 over every instance of the plan, and one run of the program on
costs rounded to bfloat16; for each ``--fault-seeds`` seed, one run with
each of ``control.FAULTS`` planted. Prints one JSON line per reading,
with every number the judge compares; the limits play no part in the
numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()

    import torch

    from ramabench import control, harness, manifest
    from repro_torch.core.solver import SolverConfig

    man = manifest.Manifest(ROOT / "BENCHMARK.json")
    cell = man.cell(args.workload)
    config = man.config(cell)
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"])
    max_neg = SolverConfig().max_neg
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")

    def run(seed, cost=None):
        t0 = time.perf_counter()
        res, checks, r = harness.run_cell(
            cell, config, traffic, limits, seed, args.seconds, False,
            device, t0, [], cost=cost)
        return dict(correct=res["correct"], attempted=res["attempted"],
                    failed=res["failed"], answers=len(r.records),
                    numbers={k: v for k, (v, _) in checks.items()})

    for seed in args.seeds:
        print(json.dumps(dict(kind="program", seed=seed, **run(seed))),
              flush=True)
    for seed in args.control_seeds:
        vals = control.reference_in_place(config, traffic, seed, limits,
                                          max_neg)
        print(json.dumps(dict(kind="reference_bf16", seed=seed,
                              numbers=vals)), flush=True)
        costs = control.bf16_costs(config, traffic, seed, max_neg)
        print(json.dumps(dict(kind="program_bf16_costs", seed=seed,
                              **run(seed, costs))), flush=True)
    for seed in args.fault_seeds:
        for fault in control.FAULTS:
            with control.planted(fault):
                got = run(seed)
            print(json.dumps(dict(kind=fault, seed=seed, **got)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
