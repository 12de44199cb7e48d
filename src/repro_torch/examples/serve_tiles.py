"""Segmentation-tile serving: a stream of per-tile multicut instances
through the bucketed solve engine; the port of ``examples/serve_tiles.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_tiles [--device cpu]

Many *independent*, mixed-size instances arriving as a stream (per-image
segmentation multicuts, as in "Next Generation Multicuts"): a synthetic
scene is cut into tiles of mixed sizes (finer tiles where the planted
segmentation is busy, coarse ones elsewhere — like a detector emitting
regions of interest); every tile becomes a grid multicut instance and the
whole stream is served by :class:`repro_torch.serve.SolveEngine`:

* tiles are routed by size (small -> dense separation, large -> sparse
  CSR) and padded onto geometric shape buckets,
* same-bucket tiles ride one dispatch (micro-batching),
* the warm-up makes every first call of the stream: at most one per
  bucket, route and sub-batch ladder rung, however many tiles arrive
  (the port's counterpart of the reference's compile bound); the stream
  itself makes none.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.graph import grid_instance, resolve_device
from repro_torch.serve import (
    BucketPolicy, SolveEngine, batch_ladder, default_router,
)

SCENE = 48          # scene is SCENE x SCENE pixels
COARSE = 16         # coarse tile edge; busy regions split into 8x8 tiles
BATCH_CAP = 8


def make_tiles(device, seed: int = 0):
    """Mixed-size tiling: coarse tiles, except the centre tile, which is
    split 4-way (stand-in for a saliency-driven tiler)."""
    rng = np.random.default_rng(seed)
    tiles = []
    for ty in range(0, SCENE, COARSE):
        for tx in range(0, SCENE, COARSE):
            centre = (SCENE // 3 <= ty < 2 * SCENE // 3
                      and SCENE // 3 <= tx < 2 * SCENE // 3)
            step = COARSE // 2 if centre else COARSE
            for y in range(ty, ty + COARSE, step):
                for x in range(tx, tx + COARSE, step):
                    tiles.append((y, x, step,
                                  grid_instance(step, step,
                                                seed=int(rng.integers(1e6)),
                                                n_segments=3,
                                                pad_edges=5 * step * step,
                                                device=device)))
    return tiles


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    tiles = make_tiles(dev)
    insts = [t[3] for t in tiles]
    print(f"== serving {len(insts)} segmentation tiles "
          f"({sorted({t[2] for t in tiles})}-px edges) ==")

    engine = SolveEngine(router=default_router(),
                         policy=BucketPolicy(node_floor=64, edge_floor=256),
                         batch_cap=BATCH_CAP, flush_timeout_s=None,
                         device=dev)
    engine.warmup([(i.num_nodes, i.num_edges) for i in insts])
    warm = engine.stats.compiles
    print(f"warmup: {warm} first calls (buckets x routes x ladder rungs)")

    t0 = time.perf_counter()
    tickets = engine.submit_many(insts)
    engine.flush()
    engine.drain()
    results = [t.result() for t in tickets]
    wall = time.perf_counter() - t0

    keys = {(t.bucket, t.route) for t in tickets}
    bound = len({k[0] for k in keys}) * len({k[1] for k in keys}) \
        * len(batch_ladder(BATCH_CAP))
    assert engine.stats.compiles == warm <= bound, \
        f"{engine.stats.compiles} first calls ({warm} in the warm-up) " \
        f"over the bound {bound}"

    lat = engine.stats.latency_hist
    n_clusters = sum(len(set(r.labels.tolist())) for r in results)
    total_obj = sum(float(r.objective) for r in results)
    print(f"served {len(results)} tiles in {wall:.2f}s "
          f"({len(results) / wall:.1f} tiles/s)")
    print(f"latency p50 {lat.percentile(50):.3f}s  "
          f"p99 {lat.percentile(99):.3f}s")
    print(f"dispatches {engine.stats.n_dispatches}  "
          f"occupancy {engine.stats.occupancy:.0%}  "
          f"first calls {engine.stats.compiles} (bound {bound})")
    print(f"total objective {total_obj:.1f} over {n_clusters} clusters")

    # per-tile summary map (clusters found per tile, coarse grid)
    print("\nclusters per tile (scene layout, finer tiles in the centre):")
    by_pos = {(t[0], t[1]): len(set(r.labels.tolist()))
              for t, r in zip(tiles, results)}
    rows = sorted({y for y, _ in by_pos})
    for y in rows:
        cells = [f"{by_pos[(y, x)]:3d}"
                 for x in sorted(x for yy, x in by_pos if yy == y)]
        print("  " + " ".join(cells))
    return dict(tiles=tiles, tickets=tickets, results=results, wall_s=wall,
                first_calls=engine.stats.compiles, first_call_bound=bound)


if __name__ == "__main__":
    main()
