"""End-to-end LM training driver (port of the LM branch of the JAX
package's ``launch/train.py``, same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduce 8 --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

Runs a (width/depth-reduced, ``--reduce 1`` = full size) LM config with
the training substrate: the synthetic deterministic LM batch, AdamW with
warm-up and schedule, gradient accumulation, optional int8
error-feedback compression, checkpoint and restart-from-latest (rerun
with the same ``--ckpt-dir`` to resume). Runs on ``cuda`` unless
``--device`` names another device. Weights are master weights (every
leaf in the config's ``param_dtype``) from ``torch.Generator`` seed 0.
The recsys family is not ported (ROADMAP Queue 1 item 15.4).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.graph import resolve_device
from repro_torch.data import synthetic
from repro_torch.launch.serve import _reduced_lm
from repro_torch.models import transformer as tfm
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.tree import tree_leaves

# the JAX registry's archs whose families are not ported yet
UNPORTED = {"wide-deep": "recsys", "egnn": "gnn", "dimenet": "gnn",
            "mace": "gnn", "graphcast": "gnn"}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduce", type=int, default=8,
                    help="divide model dims by this factor (1 = full size)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    if args.arch in UNPORTED:
        raise NotImplementedError(
            f"repro_torch.launch.train: the {UNPORTED[args.arch]} family "
            f"({args.arch}) is not ported yet (ROADMAP Queue 1 item 15.4)")
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit(f"use examples/ for {arch.family} training")
    opt = OptimizerConfig(lr=args.lr, warmup_steps=min(50, args.steps // 4),
                          total_steps=args.steps)
    tcfg = TrainConfig(opt=opt, grad_accum=args.grad_accum,
                       compress_grads=args.compress_grads,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       log_every=max(1, args.steps // 20))
    dev = resolve_device(args.device)
    cfg = _reduced_lm(arch.cfg, args.reduce)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev, masters=True)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"{args.arch} reduced/{args.reduce}: {n_params / 1e6:.1f}M "
          f"params, batch {args.batch} x seq {args.seq} on {dev}")

    def loss_fn(p, batch):
        return tfm.loss_fn(cfg, p, batch["tokens"], batch["targets"])

    def batch_fn(step):
        return synthetic.lm_batch(step, args.batch, args.seq, cfg.vocab,
                                  device=dev)

    t0 = time.time()
    params, opt_state, history = train(loss_fn, params, batch_fn, tcfg,
                                       num_steps=args.steps)
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")
    print("loss:", " -> ".join(f"{h['loss']:.4f}" for h in history[:3]),
          "...", " -> ".join(f"{h['loss']:.4f}" for h in history[-3:]))
    return history


if __name__ == "__main__":
    main()
