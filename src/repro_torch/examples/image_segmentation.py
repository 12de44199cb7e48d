"""Unsupervised image segmentation via multicut (the paper's Cityscapes
use-case, at a small scale); the port of ``examples/image_segmentation.py``.

    PYTHONPATH=src python -m repro_torch.examples.image_segmentation \\
        [--device cpu]

A synthetic image with planted segments is converted to a grid multicut
instance (4-connectivity + long-range edges, affinity costs), solved with
PD, and rendered as ASCII next to GAEC's segmentation for comparison.

Two paths, mirroring how a deployment would use the API:

* whole image — ONE instance (576 nodes: the sparse data path under
  ``auto``): the plain single-solve path (``api.solve``);
* tiled image — MANY small instances: routed through
  :class:`repro_torch.serve.SolveEngine`, which buckets and micro-batches
  the tiles into one dispatch (see ``serve_tiles`` for the streaming
  version)."""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import api
from repro_torch.core.baselines import gaec, objective
from repro_torch.core.graph import grid_instance, resolve_device
from repro_torch.serve import SolveEngine

H = W = 24
GLYPHS = "·#o+x%@*=~^"
CONFIG = api.SolverConfig(max_neg=4096, max_tri_per_edge=8, nbr_k=8,
                          mp_iters=10, contract_frac=0.5, max_rounds=40)


def render(labels, h, w):
    lab = np.asarray(labels)[: h * w].reshape(h, w)
    # relabel by frequency so glyphs are stable
    uniq, counts = np.unique(lab, return_counts=True)
    order = {u: i for i, u in enumerate(uniq[np.argsort(-counts)])}
    return "\n".join(
        "".join(GLYPHS[order[lab[y, x]] % len(GLYPHS)] for x in range(w))
        for y in range(h))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    inst = grid_instance(H, W, seed=3, n_segments=5, device=dev)
    res = api.solve(inst, mode="pd", config=CONFIG, device=dev)
    lab_gaec = gaec(inst)
    labels = res.labels.cpu().numpy()

    print(f"PD:   objective {float(res.objective):9.2f}  "
          f"LB {float(res.lower_bound):9.2f}"
          f"  clusters {len(set(labels.tolist()))}")
    print(f"GAEC: objective {objective(inst, lab_gaec):9.2f}"
          f"  clusters {len(np.unique(lab_gaec))}")
    left = render(labels, H, W).splitlines()
    right = render(lab_gaec, H, W).splitlines()
    print(f"\n{'PD segmentation':<{W + 4}}GAEC segmentation")
    for lft, rgt in zip(left, right):
        print(f"{lft}    {rgt}")

    # tiled variant: four independent quadrant instances are a batch job,
    # served through the engine (one bucketed dispatch)
    t = H // 2
    quads = [grid_instance(t, t, seed=3 * 10 + q, n_segments=3,
                           pad_edges=4 * t * t, device=dev)
             for q in range(4)]
    engine = SolveEngine(batch_cap=4, flush_timeout_s=None, device=dev)
    tile_res = engine.solve_stream(quads)
    counts = [len(set(r.labels.tolist())) for r in tile_res]
    print(f"\ntiled ({t}x{t} quadrants via SolveEngine, "
          f"{engine.stats.n_dispatches} dispatch): "
          f"clusters per tile {counts}")
    return dict(instance=inst, result=res, gaec_labels=lab_gaec,
                tile_results=tile_res)


if __name__ == "__main__":
    main()
