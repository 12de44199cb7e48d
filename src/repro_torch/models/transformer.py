"""Decoder-only transformer, dense half (port of the JAX package's
``models/transformer.py``): GQA, RoPE, SwiGLU, gemma2's local/global
alternating attention, logit softcaps, a KV-cache decode step.

Covers the dense LM configs: gemma2-9b, phi3-mini-3.8b, granite-34b. MoE
(``moe=True``) raises, naming ROADMAP Queue 1 item 15, as does training
(``loss_fn``, the flash backward).

Differences from the JAX module:
  * layers run in a Python loop over a stacked (leading L axis) parameter
    dict, not ``lax.scan``; the gemma2 pairing is layer ``2i`` local
    (``cfg.local_window``), ``2i + 1`` global, as the JAX scan over pairs.
  * no sharding (``param_pspecs``, ``kv_cache_pspecs``, ``_constrain``,
    ``act_sharding``) and no remat: one card, and no autograd. The config
    also drops the JAX fields no ported config sets or reads
    (``sliding_window``, ``max_seq``, ``tie_embeddings``) and MoE's
    ``n_experts``, ``top_k`` and ``capacity_factor``: ``moe`` stays only
    to raise, and every model has its own ``lm_head``.
  * weights: :func:`init_params` keeps the matmul weights (the projections,
    the embedding table and the head) in ``cfg.dtype`` and the norms in
    float32. The JAX package keeps every param in float32 and casts with
    ``.astype(cfg.dtype)`` at each use; casting once gives the same values
    and half the memory (gemma2-9b: 20.3 GB in bf16 instead of 40.6 GB).
  * ``decode_step`` writes the new key and value into the cache in place
    (O(1) per layer instead of the JAX masked rewrite of the whole cache,
    which exists for sharding) and returns the same cache dict. As in JAX,
    a ``cache_len`` outside the cache writes nothing.
  * attention in ``forward`` takes ``backend``: ``"cuda"`` (default) sends
    ``use_flash`` configs through the hand-written flash kernel on a CUDA
    tensor (its plain version on a CPU tensor); ``"reference"`` runs the
    plain version everywhere.

Entry points that make tensors (:func:`init_params`,
:func:`init_kv_cache`) run on ``cuda`` unless given another device.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.graph import resolve_device
from repro_torch.kernels.flash_attention import (
    attention_ref, decode_attention_ref, flash_attention,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF, default_scale

Params = dict
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _unported_moe():
    return NotImplementedError(
        "repro_torch.models.transformer: MoE (moe_block) is not ported yet "
        "(ROADMAP Queue 1 item 15)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int | None = None
    moe: bool = False                        # not ported: raises
    # attention flavour
    local_global_alternate: bool = False     # gemma2: even local / odd global
    local_window: int = 4096
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    use_flash: bool = False                  # the flash kernel path

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def params_count(self) -> int:
        """Total parameter count N (for 6ND MODEL_FLOPS accounting)."""
        d, hd, H, Hkv = self.d_model, self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        per_layer = attn + 3 * d * self.d_ff + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    @property
    def active_params_count(self) -> int:
        """Active parameters per token: all of them in a dense model."""
        return self.params_count


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _store_dtype(cfg: TransformerConfig, name: str) -> torch.dtype:
    """Matmul weights live in the compute dtype, norms in param_dtype."""
    if name in MATMUL_WEIGHTS or name in ("embed", "lm_head"):
        return cfg.dtype
    return cfg.param_dtype


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights from ``generator`` (on ``device``, cuda by default):
    normal(0, 1) scaled by 1/sqrt(fan_in) (the embedding unscaled), norms
    at one, as the JAX init. Layer weights are stacked on a leading L axis
    and drawn one layer at a time in float32, so a full-width model never
    holds more than one float32 layer matrix beside the stored weights."""
    if cfg.moe:
        raise _unported_moe()
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_params: generator on {generator.device}, "
                         f"params on {dev}")
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    H, Hkv, ff, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab

    def normal(shape, scale):
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        return out.normal_(generator=generator).mul_(scale)

    def dense(name, shape):
        out = torch.empty((L,) + shape, dtype=_store_dtype(cfg, name),
                          device=dev)
        for i in range(L):
            out[i] = normal(shape, 1.0 / math.sqrt(shape[0]))
        return out

    layers = {
        "attn_norm": torch.ones((L, d), dtype=cfg.param_dtype, device=dev),
        "wq": dense("wq", (d, H * hd)),
        "wk": dense("wk", (d, Hkv * hd)),
        "wv": dense("wv", (d, Hkv * hd)),
        "wo": dense("wo", (H * hd, d)),
        "ffn_norm": torch.ones((L, d), dtype=cfg.param_dtype, device=dev),
        "w_gate": dense("w_gate", (d, ff)),
        "w_up": dense("w_up", (d, ff)),
        "w_down": dense("w_down", (ff, d)),
    }
    return {
        "embed": normal((V, d), 1.0).to(cfg.dtype),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=cfg.param_dtype, device=dev),
        "lm_head": normal((d, V), 1.0 / math.sqrt(d)).to(cfg.dtype),
    }


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps):
    """float32 only inside the variance reduction; the normalised
    activation stays in x.dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w.to(x.dtype)


def rope(x, positions, theta):
    """x: (B, H, S, hd) -> rotated. positions: (B, S)."""
    half = x.shape[-1] // 2
    # jnp.log(theta) / half in float32, as the JAX function computes it,
    # taken to the device as a Python float (exact in float32)
    rate = float(torch.log(torch.tensor(theta, dtype=torch.float32)) / half)
    freqs = torch.exp(torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) * -rate)
    ang = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention(cfg: TransformerConfig, q, k, v, window, backend="cuda"):
    if cfg.use_flash:
        return flash_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.attn_softcap, backend=backend)
    return attention_ref(q, k, v, causal=True, window=window,
                         softcap=cfg.attn_softcap)


def _heads(x, n, hd):
    """(B, S, n * hd) -> (B, n, S, hd), a view."""
    B, S, _ = x.shape
    return x.view(B, S, n, hd).transpose(1, 2)


def attention_block(cfg: TransformerConfig, lp, x, positions, window,
                    backend="cuda"):
    """lp: single-layer params (no leading L). x: (B, S, d)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = _heads(h @ lp["wq"].to(h.dtype), H, hd)
    k = _heads(h @ lp["wk"].to(h.dtype), Hkv, hd)
    v = _heads(h @ lp["wv"].to(h.dtype), Hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = _attention(cfg, q, k, v, window, backend)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    return x + o @ lp["wo"].to(o.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = F.silu(x @ w_gate.to(x.dtype))
    u = x @ w_up.to(x.dtype)
    return (g * u) @ w_down.to(x.dtype)


def ffn_block(cfg: TransformerConfig, lp, x):
    if cfg.moe:
        raise _unported_moe()
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def layer_fn(cfg: TransformerConfig, lp, x, positions, window,
             backend="cuda"):
    x = attention_block(cfg, lp, x, positions, window, backend)
    return ffn_block(cfg, lp, x)


def layer_params(params: Params, i: int) -> Params:
    """Layer i's slice of the stacked layer params."""
    return {k: a[i] for k, a in params["layers"].items()}


def layer_window(cfg: TransformerConfig, i: int) -> int | None:
    """The attention window of layer i in ``forward``: gemma2's local
    window on even layers, none elsewhere."""
    if cfg.local_global_alternate and i % 2 == 0:
        return cfg.local_window
    return None


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward_hidden(cfg: TransformerConfig, params: Params, tokens,
                   positions=None, backend="cuda"):
    """tokens: (B, S) int -> final-norm hidden states (B, S, d)."""
    if cfg.moe:
        raise _unported_moe()
    if cfg.local_global_alternate and cfg.n_layers % 2:
        raise ValueError("local/global alternation needs an even n_layers")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    x = params["embed"][tokens].to(cfg.dtype)
    for i in range(cfg.n_layers):
        x = layer_fn(cfg, layer_params(params, i), x, positions,
                     layer_window(cfg, i), backend)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _final_softcap(cfg: TransformerConfig, logits):
    """In place: the (B, S, V) float32 logits are the largest tensor of a
    prefill (8.4 GB for gemma2-9b at S = 8192)."""
    if cfg.final_softcap is not None:
        logits.div_(cfg.final_softcap).tanh_().mul_(cfg.final_softcap)
    return logits


def forward_logits_from_hidden(cfg: TransformerConfig, params: Params, x):
    logits = (x @ params["lm_head"].to(x.dtype)).float()
    return _final_softcap(cfg, logits)


def forward(cfg: TransformerConfig, params: Params, tokens,
            positions=None, backend="cuda"):
    """tokens: (B, S) int -> logits (B, S, V) float32."""
    x = forward_hidden(cfg, params, tokens, positions, backend)
    return forward_logits_from_hidden(cfg, params, x)


# ---------------------------------------------------------------------------
# decode (serve path)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: TransformerConfig, batch: int, seq: int,
                  device=None):
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def decode_step(cfg: TransformerConfig, params: Params, token, cache,
                cache_len: int):
    """One-token decode: token (B,) int, cache from init_kv_cache (updated
    in place), cache_len the current fill (a Python int; the new token's
    position). Returns (logits (B, V) float32, cache)."""
    if cfg.moe:
        raise _unported_moe()
    cache_len = int(cache_len)
    B = token.shape[0]
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = cache["k"].shape[3]
    x = params["embed"][token[:, None]].to(cfg.dtype)
    positions = torch.full((B, 1), cache_len, dtype=torch.int32,
                           device=token.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = _heads(h @ lp["wq"].to(h.dtype), Hq, hd)
        k = _heads(h @ lp["wk"].to(h.dtype), Hkv, hd)
        v = _heads(h @ lp["wv"].to(h.dtype), Hkv, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if 0 <= cache_len < S:
            k_cache[:, :, cache_len] = k[:, :, 0].to(k_cache.dtype)
            v_cache[:, :, cache_len] = v[:, :, 0].to(v_cache.dtype)
        if cfg.local_global_alternate:
            window = cfg.local_window if i % 2 == 0 else 2 ** 30
            o = _decode_attn_dyn_window(cfg, q, k_cache, v_cache,
                                        cache_len + 1, window)
        else:
            o = decode_attention_ref(q, k_cache, v_cache, cache_len + 1,
                                     softcap=cfg.attn_softcap)
        o = o.transpose(1, 2).reshape(B, 1, Hq * hd)
        x = x + o @ lp["wo"].to(o.dtype)
        x = ffn_block(cfg, lp, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"].to(x.dtype)).float()
    return _final_softcap(cfg, logits), cache


def _decode_attn_dyn_window(cfg, q, k_cache, v_cache, cache_len, window):
    """Decode attention with a per-layer window (gemma2), grouped-GQA form
    as decode_attention_ref."""
    B, Hq, Q, D = q.shape
    Hkv = k_cache.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, Q, D)
    scale = default_scale(D, q.dtype)
    logits = torch.einsum("bkrqd,bksd->bkrqs", qg, k_cache).float() * scale
    if cfg.attn_softcap is not None:
        logits = cfg.attn_softcap * torch.tanh(logits / cfg.attn_softcap)
    pos = torch.arange(k_cache.shape[2], device=q.device)
    mask = (pos < cache_len) & (pos > cache_len - 1 - window)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkrqs,bksd->bkrqd", p.to(q.dtype), v_cache)
    return out.reshape(B, Hq, Q, D)
