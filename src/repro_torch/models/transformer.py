"""Decoder-only transformer (port of the JAX package's
``models/transformer.py``): dense and MoE, GQA, RoPE, SwiGLU, gemma2's
local/global alternating attention, logit softcaps, a KV-cache decode
step, and the chunked cross-entropy loss of the training step.

Covers the LM configs: gemma2-9b, phi3-mini-3.8b, granite-34b (dense),
llama4-scout-17b-a16e (MoE, 16 experts top-1), grok-1-314b (MoE, 8
experts top-2).

Differences from the JAX module:
  * layers run in a Python loop over a stacked (leading L axis) parameter
    dict, not ``lax.scan``; the gemma2 pairing is layer ``2i`` local
    (``cfg.local_window``), ``2i + 1`` global, as the JAX scan over pairs.
    With ``cfg.remat`` and autograd recording, each layer runs under
    ``torch.utils.checkpoint`` (recomputed in backward; the JAX remat
    policies other than "nothing" have no counterpart).
  * no sharding (``param_pspecs``, ``kv_cache_pspecs``, ``_constrain``,
    ``act_sharding``): one card. MoE dispatch is one group (the JAX
    ``moe_groups`` on one device). The config drops the JAX fields no
    ported config sets or reads (``sliding_window``, ``max_seq``,
    ``tie_embeddings``, the sharding and roofline switches): every model
    has its own ``lm_head``.
  * MoE top-k is a stable descending sort of the gates, so equal gates
    go to the lower expert index, as ``jax.lax.top_k`` breaks ties. The
    dispatch writes each kept token into its own (expert, slot) row and
    the combine gathers it back (the JAX scatter-add adds a dropped
    token's zero row to slot (0, 0)): no float accumulation decides the
    buffer, so the card's buffer equals the CPU's.
  * weights: :func:`init_params` keeps the matmul weights (the
    projections, the router, the embedding table and the head) in
    ``cfg.dtype`` and the norms in ``param_dtype`` (serving). The JAX
    package keeps every param in ``param_dtype`` and casts with
    ``.astype(cfg.dtype)`` at each use; casting once gives the same
    values and half the memory (gemma2-9b: 20.3 GB in bf16 instead of
    40.6 GB). Training holds masters: ``init_params(..., masters=True)``
    stores every leaf in ``param_dtype``, and the model casts at use, as
    JAX does.
  * ``decode_step`` writes the new key and value into the cache in place
    (O(1) per layer instead of the JAX masked rewrite of the whole cache,
    which exists for sharding) and returns the same cache dict. As in JAX,
    a ``cache_len`` outside the cache writes nothing.
  * attention in ``forward`` and ``loss_fn`` takes ``backend``:
    ``"cuda"`` (default) sends ``use_flash`` configs through the
    hand-written flash kernel on a CUDA tensor (its plain version on a CPU
    tensor), through ``flash_attention_trainable`` when a gradient is
    needed; ``"reference"`` runs the plain version everywhere.
  * ``loss_fn`` picks the target logit with a gather, where JAX sums the
    logits against a one-hot mask (for vocab sharding): the same value.

Entry points that make tensors (:func:`init_params`,
:func:`init_kv_cache`) run on ``cuda`` unless given another device.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.graph import resolve_device
from repro_torch.kernels.flash_attention import (
    attention_ref, decode_attention_ref, flash_attention,
    flash_attention_trainable,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF, default_scale

Params = dict
MATMUL_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "router")


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
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # attention flavour
    local_global_alternate: bool = False     # gemma2: even local / odd global
    local_window: int = 4096
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True                       # recompute layers in backward
    use_flash: bool = False                  # the flash kernel path

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def params_count(self) -> int:
        """Total parameter count N (for 6ND MODEL_FLOPS accounting)."""
        d, hd, H, Hkv = self.d_model, self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        if self.moe:
            ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    @property
    def active_params_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if not self.moe:
            return self.params_count
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model \
            * self.d_ff
        return self.params_count - self.n_layers * inactive


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _store_dtype(cfg: TransformerConfig, name: str,
                 masters: bool = False) -> torch.dtype:
    """Serving: matmul weights live in the compute dtype, norms in
    param_dtype. Masters: every leaf in param_dtype."""
    if not masters and (name in MATMUL_WEIGHTS
                        or name in ("embed", "lm_head")):
        return cfg.dtype
    return cfg.param_dtype


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None, masters: bool = False) -> Params:
    """Random weights from ``generator`` (on ``device``, cuda by default):
    normal(0, 1) scaled by 1/sqrt(fan_in) (the embedding unscaled), norms
    at one, as the JAX init. Layer weights are stacked on a leading L axis
    (experts on a second E axis) and drawn one (layer, expert) matrix at a
    time in float32, so a full-width model never holds more than one
    float32 matrix beside the stored weights. ``masters`` stores every
    leaf in ``cfg.param_dtype`` (the training layout) from the same
    draws."""
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
        out = torch.empty((L,) + shape,
                          dtype=_store_dtype(cfg, name, masters), device=dev)
        for idx in itertools.product(range(L), *map(range, shape[:-2])):
            out[idx] = normal(shape[-2:], 1.0 / math.sqrt(shape[-2]))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=cfg.param_dtype, device=dev)

    layers = {
        "attn_norm": ones((L, d)),
        "wq": dense("wq", (d, H * hd)),
        "wk": dense("wk", (d, Hkv * hd)),
        "wv": dense("wv", (d, Hkv * hd)),
        "wo": dense("wo", (H * hd, d)),
        "ffn_norm": ones((L, d)),
    }
    E = (cfg.n_experts,) if cfg.moe else ()
    if cfg.moe:
        layers["router"] = dense("router", (d, cfg.n_experts))
    layers.update({
        "w_gate": dense("w_gate", E + (d, ff)),
        "w_up": dense("w_up", E + (d, ff)),
        "w_down": dense("w_down", E + (ff, d)),
    })
    return {
        "embed": normal((V, d), 1.0).to(_store_dtype(cfg, "embed", masters)),
        "layers": layers,
        "final_norm": ones((d,)),
        "lm_head": normal((d, V), 1.0 / math.sqrt(d)).to(
            _store_dtype(cfg, "lm_head", masters)),
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


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _attention(cfg: TransformerConfig, q, k, v, window, backend="cuda"):
    if cfg.use_flash:
        attend = flash_attention_trainable if _needs_grad(q, k, v) \
            else flash_attention
        return attend(q, k, v, causal=True, window=window,
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


class Routing(NamedTuple):
    """Token-choice routing of N tokens: for each (token, choice) its
    expert, renormalised gate weight, position in that expert's buffer and
    whether it fits the capacity."""
    top_e: torch.Tensor      # (N, K) int64
    top_w: torch.Tensor      # (N, K) float32
    pos: torch.Tensor        # (N, K) int64
    keep: torch.Tensor       # (N, K) bool
    capacity: int


def moe_gates(router, x) -> torch.Tensor:
    """x: (N, d) -> (N, E) float32 gates: the router logits in x's dtype
    (as JAX's ``x @ router``), then a float32 softmax."""
    return torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)


def route_from_gates(cfg: TransformerConfig, gates) -> Routing:
    """The top ``cfg.top_k`` gates by a stable descending sort (ties to
    the lower expert), renormalised; position in expert as the exclusive
    cumsum over the (N K, E) one-hot, token-major and choice-minor; kept
    below the capacity of N tokens."""
    N, E = gates.shape
    K = cfg.top_k
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = F.one_hot(top_e.reshape(-1), E)                   # (N K, E)
    pos = (flat.cumsum(0) - flat).gather(1, top_e.reshape(-1, 1))
    # slots per expert: Python's truncation of the JAX float expression
    C = max(int(cfg.capacity_factor * N * K / E), 1)
    pos = pos.view(N, K)
    return Routing(top_e, top_w, pos, pos < C, C)


def moe_route(cfg: TransformerConfig, router, x) -> Routing:
    """Token-choice routing of x (N, d) by ``router`` (d, E)."""
    return route_from_gates(cfg, moe_gates(router, x))


def moe_block(cfg: TransformerConfig, lp, h):
    """Fixed-capacity token-choice MoE over one dispatch group.

    h: (B, S, d) normalised input. Each kept (token, choice) goes to row
    (expert, position) of an (E, C, d) buffer; every expert runs SwiGLU on
    its C rows; each token sums its kept experts' rows weighted by its
    gates. A dropped choice adds nothing. Returns (B, S, d)."""
    B, S, d = h.shape
    E, K = cfg.n_experts, cfg.top_k
    x = h.reshape(B * S, d)
    N = x.shape[0]
    r = moe_route(cfg, lp["router"], x)
    C = r.capacity
    # slot of each (token, choice); dropped ones go to slot E C, cut off
    slot = torch.where(r.keep, r.top_e * C + r.pos, E * C)
    # the token in each slot: the kept slots are distinct, so this
    # non-accumulating write sets each of them once
    token = torch.full((E * C + 1,), N, dtype=torch.long, device=h.device)
    token.index_put_((slot.reshape(-1),),
                     torch.arange(N, device=h.device).repeat_interleave(K))
    buf = torch.cat([x, x.new_zeros(1, d)])[token[:E * C]].view(E, C, d)
    dt = h.dtype
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, lp["w_gate"].to(dt)))
    u = torch.einsum("ecd,edf->ecf", buf, lp["w_up"].to(dt))
    y = torch.einsum("ecf,efd->ecd", g * u, lp["w_down"].to(dt))
    rows = torch.cat([y.reshape(E * C, d), y.new_zeros(1, d)])[slot]
    out = (rows * r.top_w[..., None].to(dt)).sum(1)
    return out.view(B, S, d)


def ffn_block(cfg: TransformerConfig, lp, x):
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if cfg.moe:
        return x + moe_block(cfg, lp, h)
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
# forward / loss
# ---------------------------------------------------------------------------

def _remat(fn, *args):
    """``fn(*args)``, recomputed in backward (no RNG state: the model
    draws nothing)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def forward_hidden(cfg: TransformerConfig, params: Params, tokens,
                   positions=None, backend="cuda"):
    """tokens: (B, S) int -> final-norm hidden states (B, S, d)."""
    if cfg.local_global_alternate and cfg.n_layers % 2:
        raise ValueError("local/global alternation needs an even n_layers")
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    x = F.embedding(tokens, params["embed"]).to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        args = (cfg, layer_params(params, i), x, positions,
                layer_window(cfg, i), backend)
        x = _remat(layer_fn, *args) if remat else layer_fn(*args)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _final_softcap(cfg: TransformerConfig, logits):
    """In place when no gradient flows: the (B, S, V) float32 logits are
    the largest tensor of a prefill (8.4 GB for gemma2-9b at S = 8192)."""
    if cfg.final_softcap is None:
        return logits
    cap = cfg.final_softcap
    if _needs_grad(logits):
        return cap * torch.tanh(logits / cap)
    return logits.div_(cap).tanh_().mul_(cap)


def forward_logits_from_hidden(cfg: TransformerConfig, params: Params, x):
    logits = (x @ params["lm_head"].to(x.dtype)).float()
    return _final_softcap(cfg, logits)


def forward(cfg: TransformerConfig, params: Params, tokens,
            positions=None, backend="cuda"):
    """tokens: (B, S) int -> logits (B, S, V) float32."""
    x = forward_hidden(cfg, params, tokens, positions, backend)
    return forward_logits_from_hidden(cfg, params, x)


def _chunk_loss(cfg: TransformerConfig, x, head, targets):
    """Summed cross-entropy of hidden states x (B, n, d) against targets
    (B, n), the head already in x's dtype."""
    logits = _final_softcap(cfg, (x @ head).float())
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets[..., None].long())[..., 0]
    return (logz - tgt).sum()


def loss_fn(cfg: TransformerConfig, params: Params, tokens, targets,
            chunk: int = 512, backend="cuda"):
    """Mean cross-entropy of ``targets`` (B, S) under the logits of
    ``tokens`` (B, S). The head matmul and the loss run over S in chunks
    of ``chunk``, each recomputed in backward, when S is a multiple of
    ``chunk`` above it; S <= chunk is one chunk; any other S falls back to
    one shot over the full S, as the JAX function does."""
    x = forward_hidden(cfg, params, tokens, backend=backend)
    head = params["lm_head"].to(x.dtype)
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk == 0 and S // chunk > 1:
        run = _remat if torch.is_grad_enabled() else (lambda f, *a: f(*a))
        total = torch.stack([
            run(_chunk_loss, cfg, x[:, i:i + chunk], head,
                targets[:, i:i + chunk]) for i in range(0, S, chunk)]).sum()
    else:       # one chunk, or ragged: one shot over the full S
        total = _chunk_loss(cfg, x, head, targets)
    return total / (B * S)


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
