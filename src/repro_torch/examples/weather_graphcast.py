"""GraphCast-style weather emulation: the native encoder→processor→decoder
path on a (reduced) lat/lon grid with an icosahedral mesh; the port of
``examples/weather_graphcast.py``.

    PYTHONPATH=src python -m repro_torch.examples.weather_graphcast \\
        [--device cpu] [--steps 200]

Trains the model to emulate synthetic advection dynamics and reports the
one-step MSE before/after and a short autoregressive rollout."""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.graph import resolve_device
from repro_torch.data.synthetic import grid_weather_batch
from repro_torch.models.gnn import graphcast as gc
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.tree import tree_leaves

CFG = gc.GraphCastConfig(n_layers=4, d_hidden=32, mesh_refinement=2,
                         n_vars=8, grid_lat=12, grid_lon=24)
STEPS = 200


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    steps = args.steps

    topo = gc.build_topology(CFG, seed=0, device=dev)
    params = gc.init_params(CFG, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"graphcast: grid {CFG.grid_lat}x{CFG.grid_lon}, "
          f"mesh {CFG.n_mesh} nodes, {n_params / 1e3:.0f}k params")

    def loss_fn(p, batch):
        return gc.loss_fn(CFG, p, batch["grid_feats"], batch["target"], topo)

    def batch_fn(step):
        return grid_weather_batch(step, CFG.n_grid, CFG.n_vars, device=dev)

    tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=20,
                                           total_steps=steps),
                       log_every=max(1, steps // 10))
    params, _, hist = train(loss_fn, params, batch_fn, tcfg,
                            num_steps=steps)
    print("loss:", " -> ".join(f"{h['loss']:.4f}" for h in hist[:2]),
          "...", f"{hist[-1]['loss']:.4f}")
    assert hist[-1]["loss"] < hist[0]["loss"], "training must reduce MSE"

    # autoregressive rollout
    state = grid_weather_batch(0, CFG.n_grid, CFG.n_vars,
                               device=dev)["grid_feats"]
    with torch.no_grad():
        for t in range(5):
            state = gc.forward(CFG, params, state, topo)
            print(f"rollout step {t}: mean |state| = "
                  f"{float(state.abs().mean()):.3f}")
    print("OK")
    return hist


if __name__ == "__main__":
    main()
