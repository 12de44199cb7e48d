"""Batched serving loop: prefill + decode with a KV cache (port of the
JAX package's ``launch/serve.py``, same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --reduce 16 --batch 4 --prompt-len 64 --gen 32

Serves every LM arch, the MoE ones (``llama4-scout-17b-a16e``,
``grok-1-314b``) included.

A batch of prompts is prefilled token by token into the cache through
``decode_step``, then new tokens are decoded greedily. Continuous batching
is modelled by the request queue: finished sequences are replaced by
queued prompts in their batch slot. The loop keeps the JAX version's
semantics exactly, including one shared ``cache_len = max(pos)`` per step
for every slot and a zero token fed to every slot past its prompt (the
sampled token is not fed back), so both versions emit the same tokens on
the same weights.

Runs on ``cuda`` unless ``--device`` names another device. Weights come
from ``torch.Generator`` seed 0, prompts from ``np.random.default_rng(0)``
as in the JAX version.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.graph import resolve_device
from repro_torch.models import transformer as tfm


def _reduced_lm(cfg: tfm.TransformerConfig, factor: int):
    """Width/depth-reduced copy of an LM config (the JAX
    ``launch/train.py::_reduced_lm``): MoE keeps at most 4 experts;
    ``factor <= 1`` is full size. Both drop the activation plan (one
    card), as the JAX function does."""
    if factor <= 1:
        return dataclasses.replace(cfg, act_sharding=None)
    return dataclasses.replace(
        cfg,
        n_layers=max(2, cfg.n_layers // factor),
        d_model=max(64, cfg.d_model // factor),
        n_heads=max(2, cfg.n_heads // factor),
        n_kv_heads=max(1, min(cfg.n_kv_heads, cfg.n_heads // factor)),
        head_dim=max(16, cfg.hd // factor),
        d_ff=max(128, cfg.d_ff // factor),
        vocab=max(256, cfg.vocab // (factor * 8)),
        n_experts=min(cfg.n_experts, 4) if cfg.moe else 0,
        act_sharding=None, use_flash=False)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: tfm.TransformerConfig, params: tfm.Params, *, batch: int,
          prompt_len: int, gen: int, requests: int, log=print) -> dict:
    """Serve ``requests`` random prompts through ``batch`` slots. Returns
    the finished requests' tokens in completion order (``done``: (slot,
    tokens) pairs), the counts and the wall seconds."""
    B = batch
    max_len = prompt_len + gen
    dev = params["embed"].device
    rng = np.random.default_rng(0)
    queue = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
             for _ in range(requests)]
    served, active, pos = 0, [None] * B, np.zeros(B, np.int32)
    cache = tfm.init_kv_cache(cfg, B, max_len, dev)
    out_tokens = [[] for _ in range(B)]
    done = []
    steps = n_decoded = 0
    _sync(dev)
    t0 = time.perf_counter()

    # continuous batching loop: one global decode step per iteration; slots
    # at different fill levels share one cache_len (the max)
    while served < requests or any(a is not None for a in active):
        # fill free slots from the queue (restart their region of the cache)
        for b in range(B):
            if active[b] is None and queue:
                active[b] = queue.pop(0)
                pos[b] = 0
                out_tokens[b] = []
        if all(a is None for a in active):
            break
        # feed: the prompt token while prefilling, else 0
        feed = np.zeros(B, np.int32)
        for b in range(B):
            if active[b] is not None and pos[b] < prompt_len:
                feed[b] = active[b][pos[b]]
        cache_len = int(pos.max())
        logits, cache = tfm.decode_step(cfg, params,
                                        torch.from_numpy(feed).to(dev),
                                        cache, cache_len)
        steps += 1
        n_decoded += B
        nxt = logits.argmax(-1).to(torch.int32).cpu().numpy()
        for b in range(B):
            if active[b] is None:
                continue
            pos[b] += 1
            if pos[b] >= prompt_len:
                out_tokens[b].append(int(nxt[b]))
            if pos[b] >= max_len:
                served += 1
                log(f"request done (slot {b}): "
                    f"{out_tokens[b][:8]}... ({len(out_tokens[b])} tokens)")
                done.append((b, out_tokens[b]))
                active[b] = None
    _sync(dev)
    dt = time.perf_counter() - t0
    log(f"served {served} requests, {n_decoded} decode steps "
        f"in {dt:.1f}s ({n_decoded / dt:.0f} steps/s)")
    return dict(served=served, steps=steps, n_decoded=n_decoded,
                seconds=dt, done=done)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--reduce", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8,
                    help="total requests served through the batch slots")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    cfg = _reduced_lm(get_arch(args.arch).cfg, args.reduce)
    dev = resolve_device(args.device)
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    return serve(cfg, params, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, requests=args.requests)


if __name__ == "__main__":
    main()
