"""Full-materialisation attention oracles (port of the JAX package's
``kernels/flash_attention/ref.py``): softmax attention with a causal mask,
GQA, a sliding window and a tanh logit softcap, and its single-token
decode form.

Dtype behaviour follows the JAX functions exactly: the logits come out of
an einsum in the inputs' dtype and only then go to float32, and the
scale is ``1 / sqrt(D)`` rounded to the inputs' dtype (for bf16
and D = 96 that is not the float32 value). The kernel and
``chunked_attention`` work in float32 instead.

``kernel_arithmetic`` is the flash kernel's own float32 arithmetic (exp2
softmax, its softcap formula, key tiles, P in bf16) for the CPU tests to
hold against the plain version; no path calls it.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def default_scale(D: int, dtype: torch.dtype) -> float:
    """``1.0 / jnp.sqrt(D).astype(dtype)``: sqrt in float32, rounded to
    ``dtype``, the reciprocal taken (and rounded) in ``dtype``; computed
    on the host and returned as a Python float (exact in float32), so no
    tensor goes to the device."""
    return float(1.0 / torch.sqrt(torch.tensor(float(D))).to(dtype))


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  softcap: float | None = None):
    """q: (B, Hq, S, D), k/v: (B, Hkv, S, D) with Hq % Hkv == 0.
    window: sliding-window size (keys within [i-window+1, i]); None = full.
    softcap: gemma2-style logit cap: cap * tanh(logits / cap)."""
    B, Hq, S, D = q.shape
    rep = Hq // k.shape[1]
    kk = k.repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    scale = default_scale(D, q.dtype)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), vv)


def decode_attention_ref(q, k_cache, v_cache, cache_len, *,
                         softcap: float | None = None):
    """Single-token decode: q (B, Hq, 1, D) against caches (B, Hkv, S, D);
    positions >= cache_len are masked out. Grouped-GQA form: the cache is
    not repeated. No window: the JAX function's ``window`` serves
    ``sliding_window`` configs, and no ported config is one (gemma2's
    window goes through ``transformer._decode_attn_dyn_window``)."""
    B, Hq, Q, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Q, D)
    scale = default_scale(D, q.dtype)
    logits = torch.einsum("bkrqd,bksd->bkrqs", qg, k_cache).float() * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(S, device=q.device)
    logits = torch.where(pos < cache_len, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkrqs,bksd->bkrqd", p.to(q.dtype), v_cache)
    return out.reshape(B, Hq, Q, D)


LOG2E = 1.4426950408889634


def kernel_block_k(D: int) -> int:
    """Keys per tile of the flash kernel at head dim D (``Cfg<D>::BK`` in
    ``csrc/flash_attention.cu``)."""
    return 80 if D > 128 else 128


def kernel_arithmetic(q, k, v, *, causal: bool = True,
                      window: int | None = None,
                      softcap: float | None = None,
                      block_k: int | None = None):
    """The flash kernel's own arithmetic written out in float32 torch, for
    the CPU tests (the kernel's plain version is ``chunked_attention``;
    no path calls this). Logits in the log2 domain, log2(e) folded into
    the float32 constants the host computes: ``s * c_mul`` with
    ``c_mul = scale log2(e)``, or with a softcap ``c_cap (1 - 2 r)``,
    ``r = 1 / (2^(s c_mul) + 1)``, ``c_mul = 2 log2(e) scale / cap``,
    ``c_cap = cap log2(e)`` (cap · tanh(s scale / cap) · log2(e)); masked
    logits -inf; the online recurrence over key tiles of ``block_k``
    (default: the kernel's) with exp2 and a row with no key yet based at
    0; P rounded to bf16 for P V; ``acc * (1 / max(l, 1e-30))`` in q's
    dtype. The kernel uses the hardware's ex2/rcp approximations
    (relative error ~2^-22) where this uses exact float32 functions."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    bk = block_k or kernel_block_k(D)
    f32 = np.float32
    scale = f32(1.0 / D ** 0.5)                 # as the wrapper passes it
    if softcap is not None:
        c_mul = f32(2.0) * f32(LOG2E) * scale / f32(softcap)
        c_cap = f32(softcap) * f32(LOG2E)
    else:
        c_mul = scale * f32(LOG2E)
    qg = q.reshape(B, Hkv, Hq // Hkv, S, D).float()
    kf, vf = k.float(), v.float()
    qpos = torch.arange(S, device=q.device)[:, None]
    m = torch.full(qg.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for k0 in range(0, S, bk):
        s = torch.einsum("bkrqd,bksd->bkrqs", qg, kf[:, :, k0:k0 + bk])
        if softcap is not None:
            r = 1.0 / (torch.exp2(s * float(c_mul)) + 1.0)
            x = float(c_cap) - float(2 * c_cap) * r
        else:
            x = s * float(c_mul)
        kpos = torch.arange(k0, min(k0 + bk, S), device=q.device)[None]
        ok = torch.ones((S, kpos.shape[1]), dtype=torch.bool,
                        device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        x = torch.where(ok, x, -torch.inf)
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        base = torch.where(mx == -torch.inf, 0.0, mx)
        alpha = torch.exp2(m - base)
        p = torch.exp2(x - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bkrqs,bksd->bkrqd", p.bfloat16().float(), vf[:, :, k0:k0 + bk])
        m = mx
    out = acc * (1.0 / l.clamp_min(1e-30))
    return out.to(q.dtype).reshape(B, Hq, S, D)
