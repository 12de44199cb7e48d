"""Quickstart: solve a multicut instance with the unified RAMA solver API;
the port of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a random signed graph (200 nodes padded to 256: the dense data
path under ``auto``), runs the paper's solver modes through
``repro_torch.api``, a batch served by the solve engine, and the GAEC
baseline, and prints objectives, the dual lower bound and the primal-dual
gap."""
from __future__ import annotations

import argparse

from repro_torch import api
from repro_torch.core.baselines import gaec, objective
from repro_torch.core.graph import random_instance, resolve_device
from repro_torch.serve import SolveEngine

INSTANCE = dict(n=200, p=0.08, pad_edges=4096, pad_nodes=256)
CONFIG = api.SolverConfig(max_neg=1024, max_tri_per_edge=8, mp_iters=10)
MODES = ("p", "pd", "pd+", "d")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    inst = random_instance(seed=0, device=dev, **INSTANCE)
    cfg = CONFIG

    print("== RAMA quickstart: 200-node random signed graph ==")
    res = {m: api.solve(inst, mode=m, config=cfg, device=dev) for m in MODES}
    res_p, res_pd, res_d = res["p"], res["pd"], res["d"]
    print(f"P   (primal only)     objective {float(res_p.objective):10.3f}   "
          f"rounds {int(res_p.rounds)}")
    gap = float(res_pd.objective) - float(res_pd.lower_bound)
    print(f"PD  (primal-dual)     objective {float(res_pd.objective):10.3f}   "
          f"LB {float(res_pd.lower_bound):10.3f}   gap {gap:.3f}")
    print(f"PD+ (5-cycles always) objective "
          f"{float(res['pd+'].objective):10.3f}")
    per_round = ["%.1f" % x for x in res_d.lb_history.tolist()]
    print(f"D   (dual only)       LB {float(res_d.lower_bound):10.3f}   "
          f"per-round {per_round}")

    lab_gaec = gaec(inst)
    g = objective(inst, lab_gaec)
    print(f"GAEC (CPU baseline)   objective {g:10.3f}")

    n_clusters = len(set(res_pd.labels.tolist()))
    rel = abs(gap / max(abs(float(res_pd.objective)), 1e-9)) * 100
    print(f"\nPD found {n_clusters} clusters; certificate: solution is "
          f"within {gap:.3f} ({rel:.1f}%) of the optimum.")

    # batched serving: the engine buckets shapes, micro-batches
    # same-bucket requests into one dispatch, and strips the padding on
    # the way out (api.solve above stays the single-solve path)
    insts = [random_instance(seed=s, device=dev, **INSTANCE)
             for s in range(4)]
    engine = SolveEngine(batch_cap=4, flush_timeout_s=None, device=dev)
    res_b = engine.solve_stream(insts)
    objs = ", ".join(f"{float(r.objective):.1f}" for r in res_b)
    print(f"\nserved {len(insts)} instances through the engine "
          f"({engine.stats.n_dispatches} dispatch, "
          f"{engine.stats.compiles} first-calls): objectives [{objs}]")
    return dict(instance=inst, results=res, gaec_labels=lab_gaec,
                gaec_objective=g, served=res_b, engine=engine.stats)


if __name__ == "__main__":
    main()
