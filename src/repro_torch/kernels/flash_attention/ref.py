"""Full-materialisation attention oracles (port of the JAX package's
``kernels/flash_attention/ref.py``): softmax attention with a causal mask,
GQA, a sliding window and a tanh logit softcap, and its single-token
decode form.

Dtype behaviour follows the JAX functions exactly: the logits come out of
an einsum in the inputs' dtype and only then go to float32, and the
scale is ``1 / sqrt(D)`` rounded to the inputs' dtype (for bf16
and D = 96 that is not the float32 value). The kernel and
``chunked_attention`` work in float32 instead.
"""
from __future__ import annotations

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
