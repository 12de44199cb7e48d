"""End-to-end training driver (port of the JAX package's
``launch/train.py``, same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \
        --reduce 8 --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --arch wide-deep \
        --reduce 8 --steps 200 --batch 512

Runs a (width/depth-reduced, ``--reduce 1`` = full size) LM config, or
the wide-deep recommender with ``vocab_per_field`` divided by
``reduce**2`` (at least 1 000), with the training substrate: the
synthetic deterministic batches, AdamW with warm-up and schedule,
gradient accumulation, optional int8 error-feedback compression,
checkpoint and restart-from-latest (rerun with the same ``--ckpt-dir``
to resume). Runs on ``cuda`` unless ``--device`` names another device.
Weights are drawn from ``torch.Generator`` seed 0 (an LM's as master
weights, every leaf in the config's ``param_dtype``). The GNN archs
train through the examples (``repro_torch.examples``), as in the JAX
driver.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.graph import resolve_device
from repro_torch.data import synthetic
from repro_torch.launch.serve import _reduced_lm
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tfm
from repro_torch.train.loop import TrainConfig, train
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.tree import tree_leaves


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

    arch = get_arch(args.arch)
    if arch.family not in ("lm", "recsys"):
        raise SystemExit(f"use examples/ for {arch.family} training")
    opt = OptimizerConfig(lr=args.lr, warmup_steps=min(50, args.steps // 4),
                          total_steps=args.steps)
    tcfg = TrainConfig(opt=opt, grad_accum=args.grad_accum,
                       compress_grads=args.compress_grads,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       log_every=max(1, args.steps // 20))
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    if arch.family == "lm":
        cfg = _reduced_lm(arch.cfg, args.reduce)
        params = tfm.init_params(cfg, gen, dev, masters=True)
        shape = f"batch {args.batch} x seq {args.seq}"

        def loss_fn(p, batch):
            return tfm.loss_fn(cfg, p, batch["tokens"], batch["targets"])

        def batch_fn(step):
            return synthetic.lm_batch(step, args.batch, args.seq, cfg.vocab,
                                      device=dev)
    else:
        cfg = dataclasses.replace(arch.cfg, vocab_per_field=max(
            1000, arch.cfg.vocab_per_field // (args.reduce ** 2)))
        params = rs.init_params(cfg, gen)
        shape = f"batch {args.batch}, {cfg.vocab_per_field} rows a field"

        def loss_fn(p, batch):
            return rs.loss_fn(cfg, p, batch["sparse_idx"],
                              batch["dense_feats"], batch["labels"])

        def batch_fn(step):
            return synthetic.recsys_batch(step, args.batch, cfg.n_sparse,
                                          cfg.vocab_per_field, cfg.n_dense,
                                          bag=cfg.multi_hot, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"{args.arch} reduced/{args.reduce}: {n_params / 1e6:.1f}M "
          f"params, {shape} on {dev}")

    t0 = time.time()
    params, opt_state, history = train(loss_fn, params, batch_fn, tcfg,
                                       num_steps=args.steps)
    dt = time.time() - t0
    lm = arch.family == "lm"
    rate = args.steps * args.batch * (args.seq if lm else 1) / dt
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({rate:.0f} {'tok' if lm else 'ex'}/s)")
    print("loss:", " -> ".join(f"{h['loss']:.4f}" for h in history[:3]),
          "...", " -> ".join(f"{h['loss']:.4f}" for h in history[-3:]))
    return history


if __name__ == "__main__":
    main()
