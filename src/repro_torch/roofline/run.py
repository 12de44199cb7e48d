"""Roofline table: per (arch x shape) cell on the single-pod mesh, the
three roofline terms of one rank's step, and ``results/roofline_single.
json`` (port of ``repro.roofline.run``).

Each cell's per-rank flops, bytes and collective bytes come from the pod
dry-run (:func:`repro_torch.launch.dryrun.dryrun_cell`: one traced step
on rank 0 of a ``fake`` group of 256 ranks, counted beneath DTensor on
the local shards), held against one H100's peaks
(``repro_torch.roofline.analysis.HW``; the collective term against one
card's NVLink, a floor for a model axis that spans two nodes).

Loop correction: XLA counts a loop body once, so the reference compiles
depth-1 and depth-2 variants of each LM and extrapolates. Eager counts
are direct: a cell is counted at full depth where the trace is quick
(every GNN, recsys and multicut cell; an LM no deeper than its variants);
a deeper LM is counted from its depth variants (and, for a train step, 2
and 3 of its microbatches) through ``roofline.solver.loop_corrected``,
exact because the layers and the microbatches repeat identical work
(``tests/test_torch_dryrun.py`` holds the two against each other at a
small depth).

The reference's ``*_corr`` columns halve bytes and collective bytes of
bf16 archs, because XLA:CPU upcasts bf16 dot operands to float32 and its
counts come out twice the device's. The port counts the dtypes its ops
run in, so the ``*_corr`` keys are kept, equal to the raw terms.

The rama-multicut solver and MP cells run replicated (one rank holds the
whole problem), so their flops are whole-problem flops and their model
FLOPs are not divided by the rank count; dist_pd's are per rank.

Usage:
    PYTHONPATH=src python -m repro_torch.roofline.run [--arch A] [--shape S]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.launch.dryrun import (
    ASSIGNED, dryrun_cell, fake_group, production_mesh,
)
from repro_torch.roofline.analysis import (
    dominant_term, roofline_fraction, roofline_terms, step_time_estimate,
)

__all__ = ["ASSIGNED", "main", "measure_cell"]


def measure_cell(arch_id: str, shape_name: str, mesh, *, arch=None,
                 full_depth: bool = False) -> dict:
    """The roofline record of one cell on ``mesh`` (the reference's
    keys)."""
    t0 = time.perf_counter()
    arch = arch or get_arch(arch_id)
    shape = arch.shapes[shape_name]
    rec = dryrun_cell(arch_id, shape_name, mesh, verbose=False, arch=arch,
                      full_depth=full_depth)
    flops, bytes_ = rec["flops"], rec["bytes_accessed"]
    coll = rec["collectives"]
    n_chips = mesh.size()
    terms = roofline_terms(flops, bytes_, coll["total"])
    # no bf16 upcast to correct for: the corrected terms are the raw ones
    terms_corr = {f"{k}_corr": round(v, 6) for k, v in terms.items()}
    if arch.family == "multicut" and shape.kind != "dist":
        model_flops = arch.model_flops(shape)
    else:
        model_flops = arch.model_flops(shape) / n_chips
    return {
        "arch": arch_id, "shape": shape_name, "chips": n_chips,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_,
        "collective_bytes_per_chip": coll["total"],
        "collective_breakdown": {k: v for k, v in coll.items()
                                 if k != "total" and v > 0},
        **{k: round(v, 6) for k, v in terms.items()},
        **terms_corr,
        "dominant": dominant_term(terms),
        "model_flops_per_chip": model_flops,
        "useful_flop_ratio": round(model_flops / flops, 4) if flops else 0,
        "roofline_fraction": round(roofline_fraction(model_flops, terms), 4),
        "roofline_fraction_corr": round(roofline_fraction(model_flops,
                                                          terms), 4),
        "step_time_est_s": round(step_time_estimate(terms), 6),
        "trace": rec["trace"],
        "analysis_s": round(time.perf_counter() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="results/roofline_single.json")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    arch_ids = [args.arch] if args.arch else ASSIGNED + ["rama-multicut"]
    records, failures = [], []
    t0 = time.perf_counter()
    with fake_group(256):
        mesh = production_mesh()     # the roofline table is single-pod
        for aid in arch_ids:
            arch = get_arch(aid)
            shapes = [args.shape] if args.shape else list(arch.shapes)
            for sname in shapes:
                try:
                    rec = measure_cell(aid, sname, mesh)
                    records.append(rec)
                    print(f"{aid}/{sname}: dom={rec['dominant']} "
                          f"c={rec['compute_s']:.4f}s "
                          f"m={rec['memory_s']:.4f}s "
                          f"x={rec['collective_s']:.4f}s "
                          f"useful={rec['useful_flop_ratio']:.2f} "
                          f"roofline={rec['roofline_fraction']:.2%}",
                          flush=True)
                except Exception as e:  # noqa: BLE001 (report every cell)
                    failures.append((aid, sname, repr(e)[:200]))
                    print(f"FAIL {aid}/{sname}: {e}", flush=True)
        del mesh
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(records, fh, indent=1)
    print(f"\n{len(records)} cells analysed, {len(failures)} failures, "
          f"{time.perf_counter() - t0:.1f} s -> {args.out}")
    for f in failures:
        print("  FAILED:", *f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
