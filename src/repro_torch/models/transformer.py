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
  * sharding: :func:`param_pspecs` and :func:`kv_cache_pspecs` are the
    reference's plans (``repro_torch.sharding.P``); with DTensor params
    and inputs placed by them (``configs.base.LMArch.state_shardings``),
    every function here runs on a mesh. Where XLA's partitioner decides
    the collectives, DTensor's ops do: the matmuls run Megatron-style
    (:func:`_mm`), ``_constrain`` redistributes to ``act_sharding`` at
    layer boundaries and the loss keeps the vocab split; the pieces with
    no DTensor rule run on each rank's shards under ``local_map``: the
    vocab-split embedding lookup (a masked lookup and a partial sum),
    rope, attention (exact over batch and heads: the flash kernel on the
    card, the plain version with ``backend="reference"``), the MoE
    dispatch and combine (one group a data shard, ``moe_groups``), the
    loss's target pick and the decode cache's write. With plain tensors
    none of it runs: one card computes the same bits as before. The
    config drops the JAX fields no ported config sets or reads
    (``sliding_window``, ``max_seq``, ``tie_embeddings``, the remat
    policy and the roofline switches): every model has its own
    ``lm_head``.
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
from repro_torch.sharding import (
    P, axis_sizes, constrain, dp_axes, is_dtensor, local_offset, pin,
    placements, run_local,
)

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
    moe_groups: int = 1              # GShard group-local dispatch (per mesh)
    moe_shard_experts: bool = True   # experts divide the model axis
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
    # activation plan at layer boundaries: mesh-axis entries for (batch,
    # seq, d_model), e.g. (("pod", "data"), None, "model"); applied only to
    # DTensor activations (a plain tensor is one card). None = off.
    act_sharding: tuple | None = None

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


def param_pspecs(cfg: TransformerConfig, data_axes=("pod", "data"),
                 model_axis="model", fsdp: bool = True) -> Params:
    """Specs matching :func:`init_params`' tree: tensor parallelism over
    heads, ffn and vocab, experts over the model axis (expert
    parallelism), and with ``fsdp`` ZeRO-3/FSDP sharding of the remaining
    d_model dimension over the data axes, so params and optimizer state
    divide by the whole mesh. Without it a 34B model's float32 masters and
    Adam moments are ~33 GiB a rank on a 16x16 mesh; with it ~1.6 GiB,
    well inside ``Hardware.hbm_bytes`` (80 GB). DTensor all-gathers the
    shards where an op needs them (FSDP)."""
    m = model_axis
    d = data_axes if fsdp else None
    layers = {
        "attn_norm": P(None, None),
        "wq": P(None, d, m),
        "wk": P(None, d, m),
        "wv": P(None, d, m),
        "wo": P(None, m, d),
        "ffn_norm": P(None, None),
    }
    if cfg.moe:
        layers.update({
            "router": P(None, None, None),
            "w_gate": P(None, m, d, None),
            "w_up": P(None, m, d, None),
            "w_down": P(None, m, None, d),
        })
    else:
        layers.update({
            "w_gate": P(None, d, m),
            "w_up": P(None, d, m),
            "w_down": P(None, m, d),
        })
    return {
        # vocab-only sharding of the table: sharding it on d too would
        # make the embedding gradient's scatter cross both axes; the table
        # is small enough that FSDP on d buys nothing
        "embed": P(m, None),
        "layers": layers,
        "final_norm": P(None),
        "lm_head": P(d, m),
    }


def kv_cache_pspecs(cfg: TransformerConfig, data_axes=("pod", "data"),
                    model_axis="model"):
    return {"k": P(None, data_axes, model_axis, None, None),
            "v": P(None, data_axes, model_axis, None, None)}


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
    """x: (B, H, S, hd) -> rotated. positions: (B, S), a plain tensor. A
    DTensor x (any dim but hd sharded) rotates each rank's shard with its
    own rows of ``positions``: the same bits as the whole."""
    if is_dtensor(x):
        return _on_local_rows(lambda xl, pl: rope(xl, pl, theta), x,
                              positions)
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


def _on_local_rows(fn, x, positions):
    """``fn(local x, positions[rows, cols])`` on DTensor x (B, H, S, hd),
    ``positions`` (B, S) sliced to x's local batch rows and sequence
    columns; the result carries x's placements."""
    from torch.distributed.tensor import DTensor
    loc = x.to_local()
    if loc.shape[-1] != x.shape[-1]:
        raise ValueError("rope: the head dim must not be sharded")
    off = local_offset(x.device_mesh, x.placements, x.shape)
    pos = positions[off[0]:off[0] + loc.shape[0],
                    off[2]:off[2] + loc.shape[2]]
    return DTensor.from_local(fn(loc, pos), x.device_mesh, x.placements,
                              run_check=False)


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
    """(B, S, n * hd) -> (B, n, S, hd), a view. A DTensor is first
    constrained to whole heads over the model axis (or none there), the
    batch over the data axes."""
    B, S, _ = x.shape
    if is_dtensor(x):
        x = constrain(x, P(_dp(x), None, _model_if(x, n)))
    return x.view(B, S, n, hd).transpose(1, 2)


def _mm(x, w, col: bool = True):
    """``x @ w``. DTensors run Megatron-style: column-parallel (``col``)
    takes x whole over the model axis and w's output columns over it;
    row-parallel takes x's last dim and w's rows over it (a partial sum
    over the model axis). The batch stays over the data axes and w is
    gathered over them (FSDP), so no op of the product shards the
    sequence."""
    if not is_dtensor(x):
        return x @ w
    b = _fit(x, _dp(x), x.shape[0])
    mid = [None] * (x.dim() - 2)
    if col:
        x = constrain(x, P(b, *mid, None))
        w = constrain(w, P(None, _model_if(w, w.shape[1])))
    else:
        m = _model_if(x, x.shape[-1])
        x = constrain(x, P(b, *mid, m))
        w = constrain(w, P(m, None))
    return pin(x @ w)


def _dp(x) -> tuple:
    """The data axes of DTensor x's mesh."""
    return dp_axes(x.device_mesh)


def _model_if(x, n: int):
    """"model" when x's mesh has a model axis that divides ``n``."""
    msz = axis_sizes(x.device_mesh).get("model", 0)
    return "model" if msz and n % msz == 0 else None


def _fit(x, axes, n: int):
    """The longest prefix of ``axes`` (present in x's mesh) whose sizes
    divide ``n``, or None."""
    sizes = axis_sizes(x.device_mesh)
    axes = tuple(a for a in (axes or ()) if a in sizes)
    while axes and n % math.prod(sizes[a] for a in axes):
        axes = axes[:-1]
    return axes or None


def _attention_sharded(cfg: TransformerConfig, q, k, v, window, backend):
    """Attention of DTensors, exact over batch and heads: each rank runs
    :func:`_attention` (the flash kernel on the card) on its (batch, head)
    shard under ``local_map``. Query heads go over the model axis when it
    divides them; kv heads too when it divides them, else every rank
    takes the kv heads its query heads read."""
    mesh = q.device_mesh
    B, Hq = q.shape[:2]
    Hkv = k.shape[1]
    b = _fit(q, _dp(q), B)
    hq = _model_if(q, Hq)
    hk = hq and _model_if(k, Hkv)
    q_pl = placements(mesh, P(b, hq), q.shape)
    kv_pl = placements(mesh, P(b, hk), k.shape)
    n = Hq // axis_sizes(mesh)["model"] if hq else Hq
    rep = Hq // Hkv
    lo = mesh.get_local_rank("model") * n if hq else 0
    if hq and not hk:
        for r in range(axis_sizes(mesh)["model"]):
            a, e = r * n // rep, (r * n + n - 1) // rep + 1
            if n % (e - a) or any((r * n + j) // rep - a != j // (n // (e - a))
                                  for j in range(n)):
                raise ValueError(f"attention: {n} query heads a rank do "
                                 f"not map onto whole kv heads "
                                 f"(Hq {Hq}, Hkv {Hkv})")

    def local(ql, kl, vl):
        if hq and not hk:
            a, e = lo // rep, (lo + n - 1) // rep + 1
            kl, vl = kl[:, a:e], vl[:, a:e]
        return _attention(cfg, ql, kl, vl, window, backend)

    return run_local(local, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl, mesh)


def attention_block(cfg: TransformerConfig, lp, x, positions, window,
                    backend="cuda"):
    """lp: single-layer params (no leading L). x: (B, S, d)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = _heads(_mm(h, lp["wq"].to(h.dtype)), H, hd)
    k = _heads(_mm(h, lp["wk"].to(h.dtype)), Hkv, hd)
    v = _heads(_mm(h, lp["wv"].to(h.dtype)), Hkv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if is_dtensor(q):
        o = _attention_sharded(cfg, q, k, v, window, backend)
    else:
        o = _attention(cfg, q, k, v, window, backend)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    return x + _mm(o, lp["wo"].to(o.dtype), col=False)


def swiglu(x, w_gate, w_up, w_down):
    g = F.silu(_mm(x, w_gate.to(x.dtype)))
    u = _mm(x, w_up.to(x.dtype))
    return _mm(g * u, w_down.to(x.dtype), col=False)


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


def _moe_dispatch(cfg: TransformerConfig, router, x):
    """One group's dispatch: x (N, d) -> (buf (E, C, d), slot (N, K),
    top_w (N, K)). Each kept (token, choice) goes to row (expert,
    position) of the buffer; a dropped one to slot E C, cut off."""
    N, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    r = moe_route(cfg, router, x)
    C = r.capacity
    slot = torch.where(r.keep, r.top_e * C + r.pos, E * C)
    # the token in each slot: the kept slots are distinct, so this
    # non-accumulating write sets each of them once
    token = torch.full((E * C + 1,), N, dtype=torch.long, device=x.device)
    token.index_put_((slot.reshape(-1),),
                     torch.arange(N, device=x.device).repeat_interleave(K))
    buf = torch.cat([x, x.new_zeros(1, d)])[token[:E * C]].view(E, C, d)
    return buf, slot, r.top_w


def _moe_combine(y, slot, top_w, dt):
    """Each token's kept experts' rows of y (E, C, d), weighted by its
    gates: (N, d). A dropped choice adds nothing."""
    E, C, d = y.shape
    rows = torch.cat([y.reshape(E * C, d), y.new_zeros(1, d)])[slot]
    return (rows * top_w[..., None].to(dt)).sum(1)


def _moe_group(cfg: TransformerConfig, lp, x):
    """SwiGLU experts over one dispatch group x (N, d) -> (N, d)."""
    buf, slot, top_w = _moe_dispatch(cfg, lp["router"], x)
    dt = x.dtype
    g = F.silu(torch.einsum("ecd,edf->ecf", buf, lp["w_gate"].to(dt)))
    u = torch.einsum("ecd,edf->ecf", buf, lp["w_up"].to(dt))
    y = torch.einsum("ecf,efd->ecd", g * u, lp["w_down"].to(dt))
    return _moe_combine(y, slot, top_w, dt)


def moe_groups(cfg: TransformerConfig, n_tokens: int) -> int:
    """Dispatch groups of ``n_tokens``: ``cfg.moe_groups`` when it divides
    them, else one (the reference's rule)."""
    G = max(cfg.moe_groups, 1)
    return G if n_tokens % G == 0 else 1


def moe_block(cfg: TransformerConfig, lp, h):
    """Fixed-capacity token-choice MoE with GShard-style grouped dispatch.

    h: (B, S, d) normalised input, its B S tokens split into
    :func:`moe_groups` consecutive groups, each with its own capacity C
    (one per data shard on a pod mesh, set by ``LMArch.for_mesh``; without
    grouping every rank would hold all-expert x all-capacity buffers).
    Within a group each kept (token, choice) goes to row (expert,
    position) of an (E, C, d) buffer; every expert runs SwiGLU on its C
    rows; each token sums its kept experts' rows weighted by its gates. A
    dropped choice adds nothing. Returns (B, S, d). A DTensor h runs
    :func:`_moe_block_sharded`."""
    if is_dtensor(h):
        return _moe_block_sharded(cfg, lp, h)
    B, S, d = h.shape
    G = moe_groups(cfg, B * S)
    x = h.reshape(G, B * S // G, d)
    if G == 1:
        return _moe_group(cfg, lp, x[0]).view(B, S, d)
    return torch.cat([_moe_group(cfg, lp, xg) for xg in x]).view(B, S, d)


def _moe_block_sharded(cfg: TransformerConfig, lp, h):
    """:func:`moe_block` of a DTensor h. The groups follow the data
    shards: each rank dispatches its own groups under ``local_map`` (the
    router replicated), the (G, E, C, d) buffer is a DTensor with G over
    the data axes and E over the model axis (experts replicated when
    ``cfg.moe_shard_experts`` is off: grok-1's 8 experts on a 16-way
    axis), the expert matmuls run on DTensors and each rank combines its
    own groups' rows under ``local_map``."""
    mesh = h.device_mesh
    B, S, d = h.shape
    G = moe_groups(cfg, B * S)
    dp = _fit(h, cfg.act_sharding[0] if cfg.act_sharding else _dp(h), B)
    shards = math.prod(axis_sizes(mesh)[a] for a in dp or ())
    if G % shards:
        raise ValueError(f"moe_block: {G} dispatch groups do not follow "
                         f"{shards} data shards")
    per = G // shards
    m = "model" if cfg.moe_shard_experts and "model" in axis_sizes(mesh) \
        else None
    x_pl = placements(mesh, P(dp, None, None), h.shape)
    g_pl = placements(mesh, P(dp), (G,))
    router = lp["router"]
    r_pl = placements(mesh, P())

    def dispatch(xl, rl):
        parts = [_moe_dispatch(cfg, rl, xg)
                 for xg in xl.reshape(per, -1, d)]
        return tuple(torch.stack(t) for t in zip(*parts))

    buf, slot, top_w = run_local(dispatch, (h, router), (x_pl, r_pl),
                                 (g_pl, g_pl, g_pl), mesh)
    buf = constrain(buf, P(dp, m, None, None))
    dt = h.dtype
    # experts over the model axis, or (fallback) their ffn dim over it;
    # the FSDP dims gathered over the data axes
    f = None if m else _model_if(buf, cfg.d_ff)
    w_in = [constrain(lp[k].to(dt), P(m, None, f))
            for k in ("w_gate", "w_up")]
    w_out = constrain(lp["w_down"].to(dt), P(m, f, None))
    g = F.silu(pin(torch.einsum("gecd,edf->gecf", buf, w_in[0])))
    u = pin(torch.einsum("gecd,edf->gecf", buf, w_in[1]))
    y = pin(torch.einsum("gecf,efd->gecd", g * u, w_out))
    y = constrain(y, P(dp, m, None, None))

    def combine(yl, sl, wl):
        out = [_moe_combine(a, b_, c, dt) for a, b_, c in zip(yl, sl, wl)]
        return torch.cat(out).view(-1, S, d)

    return run_local(combine, (y, slot, top_w), (g_pl, g_pl, g_pl), x_pl,
                     mesh)


def ffn_block(cfg: TransformerConfig, lp, x):
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if cfg.moe:
        return x + moe_block(cfg, lp, h)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _constrain(cfg: TransformerConfig, x):
    """The activation plan ``cfg.act_sharding`` on a DTensor x."""
    if cfg.act_sharding is not None:
        x = constrain(x, P(*cfg.act_sharding))
    return x


def layer_fn(cfg: TransformerConfig, lp, x, positions, window,
             backend="cuda"):
    x = attention_block(cfg, lp, x, positions, window, backend)
    return _constrain(cfg, ffn_block(cfg, lp, x))


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

def _embed(cfg: TransformerConfig, table, ids):
    """Rows ``table[ids]``. A DTensor table, its vocab rows sharded over
    the model axis, is looked up under ``local_map``: each rank takes the
    ids in its row range and zeros elsewhere, and the partial sum over
    the rows' axes (one nonzero term per element: exact) is reduced into
    the activation plan."""
    if not is_dtensor(table):
        return F.embedding(ids, table)
    mesh = table.device_mesh
    t_pl = list(table.placements)
    lo = local_offset(mesh, t_pl, table.shape)[0]
    i_pl = placements(mesh, P(_fit(ids, _dp(ids), ids.shape[0])),
                      ids.shape)
    from torch.distributed.tensor import Partial, Replicate, Shard
    out_pl = [Partial() if isinstance(tp, Shard) else
              (Shard(0) if isinstance(ip, Shard) else Replicate())
              for tp, ip in zip(t_pl, i_pl)]

    def lookup(tl, il):
        n = tl.shape[0]
        ok = (il >= lo) & (il < lo + n)
        rows = F.embedding((il - lo).clamp(0, n - 1), tl)
        return torch.where(ok[..., None], rows, rows.new_zeros(()))

    x = run_local(lookup, (table, ids), (t_pl, i_pl), out_pl, mesh)
    dp = _fit(x, _dp(x), x.shape[0])
    act = cfg.act_sharding
    last = act[-1] if act is not None else None
    return constrain(x, P(dp, *([None] * (x.dim() - 2)), last))


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
    x = _embed(cfg, params["embed"], tokens).to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    # one unbind of each stacked weight: its backward stacks the layers'
    # gradients once, where a select per layer would add L full-size
    # zero-padded gradients (O(L^2) work)
    layers = {k: a.unbind(0) for k, a in params["layers"].items()}
    for i in range(cfg.n_layers):
        args = (cfg, {k: v[i] for k, v in layers.items()}, x, positions,
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
    logits = _mm(x, params["lm_head"].to(x.dtype)).float()
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


def _chunk_loss_sharded(cfg: TransformerConfig, x, head, targets):
    """:func:`_chunk_loss` of DTensors: the logits keep the vocab over
    the model axis; logsumexp reduces across it and each rank picks the
    target logits in its vocab range under ``local_map`` (zero
    elsewhere; the partial sum has one nonzero term)."""
    mesh = x.device_mesh
    logits = _final_softcap(cfg, _mm(x, head).float())
    dp = _fit(logits, _dp(logits), logits.shape[0])
    logits = constrain(logits, P(dp, None, _model_if(logits,
                                                     logits.shape[-1])))
    m = logits.detach().amax(-1, keepdim=True)
    logz = (logits - m).exp().sum(-1).log() + m[..., 0]
    l_pl = list(logits.placements)
    t_pl = placements(mesh, P(dp), targets.shape)
    v0 = local_offset(mesh, l_pl, logits.shape)[2]
    from torch.distributed.tensor import Partial, Shard
    out_pl = [Partial() if isinstance(p, Shard) and p.dim == 2 else p
              for p in l_pl]

    def pick(ll, tl):
        n = ll.shape[-1]
        t = tl.long() - v0
        ok = (t >= 0) & (t < n)
        got = ll.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(ok, got, got.new_zeros(()))

    tgt = run_local(pick, (logits, targets), (l_pl, t_pl), out_pl, mesh)
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
    one = _chunk_loss_sharded if is_dtensor(x) else _chunk_loss
    if S % chunk == 0 and S // chunk > 1:
        run = _remat if torch.is_grad_enabled() else (lambda f, *a: f(*a))
        total = torch.stack([
            run(one, cfg, x[:, i:i + chunk], head,
                targets[:, i:i + chunk]) for i in range(0, S, chunk)]).sum()
    else:       # one chunk, or ragged: one shot over the full S
        total = one(cfg, x, head, targets)
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
    position). Returns (logits (B, V) float32, cache).

    A DTensor cache is written in place shard by shard (the rank whose
    sequence range holds ``cache_len`` writes the row) and attended by
    DTensor ops, which reduce across a sequence-sharded cache
    (``LMArch.kv_pspec`` shards the sequence when batch or heads do not
    divide). The in-place update keeps the cache's placements, which the
    reference pins with its per-layer ``cache_pspec``."""
    cache_len = int(cache_len)
    B = token.shape[0]
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = cache["k"].shape[3]
    sharded = is_dtensor(cache["k"])
    if sharded:
        x = _embed(cfg, params["embed"], token[:, None]).to(cfg.dtype)
    else:
        x = params["embed"][token[:, None]].to(cfg.dtype)
    positions = torch.full((B, 1), cache_len, dtype=torch.int32,
                           device=token.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = _heads(_mm(h, lp["wq"].to(h.dtype)), Hq, hd)
        k = _heads(_mm(h, lp["wk"].to(h.dtype)), Hkv, hd)
        v = _heads(_mm(h, lp["wv"].to(h.dtype)), Hkv, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if sharded:
            _cache_write(k_cache, k, cache_len)
            _cache_write(v_cache, v, cache_len)
        elif 0 <= cache_len < S:
            k_cache[:, :, cache_len] = k[:, :, 0].to(k_cache.dtype)
            v_cache[:, :, cache_len] = v[:, :, 0].to(v_cache.dtype)
        window = cfg.local_window if cfg.local_global_alternate \
            and i % 2 == 0 else 2 ** 30
        if sharded:
            o = _decode_attn_sharded(cfg, q, k_cache, v_cache,
                                     cache_len + 1, window)
        elif cfg.local_global_alternate:
            o = _decode_attn_dyn_window(cfg, q, k_cache, v_cache,
                                        cache_len + 1, window)
        else:
            o = decode_attention_ref(q, k_cache, v_cache, cache_len + 1,
                                     softcap=cfg.attn_softcap)
        o = o.transpose(1, 2).reshape(B, 1, Hq * hd)
        x = x + _mm(o, lp["wo"].to(o.dtype), col=False)
        x = ffn_block(cfg, lp, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mm(x[:, 0], params["lm_head"].to(x.dtype)).float()
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


def _cache_write(cache, new, pos: int):
    """Write ``new`` (B, Hkv, 1, hd) into row ``pos`` of the DTensor
    ``cache`` (B, Hkv, S, hd) in place: ``new`` is brought to the cache's
    batch and head placements (whole over the sequence axes), and the
    rank whose local sequence range holds ``pos`` writes it. A ``pos``
    outside the cache writes nothing."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
          for p in cache.placements]
    nl = new.redistribute(mesh, pl).to_local()
    cl = cache.to_local()
    s0 = local_offset(mesh, cache.placements, cache.shape)[2]
    if s0 <= pos < s0 + cl.shape[2]:
        with torch.no_grad():
            cl[:, :, pos - s0] = nl[:, :, 0].to(cl.dtype)


def _decode_attn_sharded(cfg, q, k_cache, v_cache, cache_len, window):
    """:func:`_decode_attn_dyn_window` of DTensors. Each rank computes the
    masked logits of its (batch, kv head, sequence) shard of the cache
    under ``local_map`` (q brought to the cache's batch and head
    placements); the softmax runs on the logits DTensor, whose max and
    sum reduce across a sequence-sharded cache; each rank's probabilities
    times its values are a partial sum over the sequence axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = k_cache.device_mesh
    B, Hq, Q, D = q.shape
    c_pl = list(k_cache.placements)

    def on_seq(p):
        return isinstance(p, Shard) and p.dim == 2

    q_pl = [Replicate() if on_seq(p) else p for p in c_pl]
    l_pl = [Shard(4) if on_seq(p) else p for p in c_pl]
    o_pl = [Partial() if on_seq(p) else p for p in c_pl]
    s0 = local_offset(mesh, c_pl, k_cache.shape)[2]
    scale = default_scale(D, q.dtype)

    def logits_fn(ql, kl):
        Bl, Hl = ql.shape[:2]
        Hk, n = kl.shape[1], kl.shape[2]
        qg = ql.reshape(Bl, Hk, Hl // Hk, Q, D)
        lg = torch.einsum("bkrqd,bksd->bkrqs", qg, kl).float() * scale
        if cfg.attn_softcap is not None:
            lg = cfg.attn_softcap * torch.tanh(lg / cfg.attn_softcap)
        pos = torch.arange(s0, s0 + n, device=kl.device)
        mask = (pos < cache_len) & (pos > cache_len - 1 - window)
        return torch.where(mask, lg, NEG_INF)

    logits = run_local(logits_fn, (q, k_cache), (q_pl, c_pl), l_pl, mesh)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)

    def out_fn(pl_, vl):
        return torch.einsum("bkrqs,bksd->bkrqd", pl_.to(q.dtype), vl)

    out = run_local(out_fn, (p, v_cache), (l_pl, c_pl), o_pl, mesh)
    return out.reshape(B, Hq, Q, D)
