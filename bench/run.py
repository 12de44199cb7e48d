#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card this process sees.

    python3 bench/run.py --workload cityscapes.pd --seed 7 --seconds 51 \
        --trace 0

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled window. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the judge compared, with
its limit); the same numbers are the last lines of standard error.

Exits 2 without a result when no CUDA card is visible or fewer than the
cell asks for, and 3 when the process loaded JAX or the JAX package.
Kernels build into ``build/`` inside the checkout, once.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"


def _environment() -> None:
    """Fixed cache directories inside the checkout, imports from it, and
    few threads on the host."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(BUILD / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "4"
    sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from ramabench import harness, manifest, modules

    man = manifest.Manifest(ROOT / "BENCHMARK.json")
    cell = man.cell(args.workload)
    import torch
    torch.set_num_threads(4)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA card(s), "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    traced = bool(args.trace)
    result, checks, run = harness.run_cell(
        cell, man.config(cell), manifest.traffic(cell["traffic"]),
        manifest.limits(cell["name"]), args.seed, args.seconds, traced,
        device, T_START, man.metrics(cell, traced))

    bad = modules.forbidden(list(sys.modules))
    if bad:
        print(f"no result: the run loaded {bad}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = _power_limit()
    if run.trace is not None:
        t = run.trace
        print(f"trace: window {t['window_s']:.3f} s, busy {t['busy_s']:.3f} s,"
              f" {t['device_events']} device events, "
              f"{t['unmatched_launches']} not tied to a launch, reduced in "
              f"{t['reduce_s']:.1f} s; phases {t['phases']}", file=sys.stderr)
    result["checks"] = harness.checks_json(checks)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    print("\n".join(harness.checks_text(checks)), file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
