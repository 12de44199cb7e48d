"""Memory-efficient chunked attention (Rabe & Staats): the plain PyTorch
version of the flash kernel (port of the JAX package's
``chunked.py::chunked_attention``; off the TPU it is what the JAX
transformer runs with ``use_flash=True``), and the backward of the
trainable flash op (``ops.flash_attention_trainable``, after the JAX
``make_flash_vjp_op``).

One (B, Hkv, rep, block_q, S) float32 score tile at a time. Logits and
the softmax are float32 (q scaled after the product, as the JAX function
does); each chunk's output is rounded to q's dtype. The JAX function pads
S up to a multiple of ``block_q``; here the last chunk is simply shorter,
which gives the same rows. With ``remat=True`` and autograd recording,
each chunk runs under ``torch.utils.checkpoint`` (the JAX
``jax.checkpoint(chunk)``), so a backward recomputes one tile at a time
instead of keeping every tile of the forward.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ref import NEG_INF


def _chunk(qc, kf, vf, q0: int, causal: bool, window: int | None,
           softcap: float | None, scale: float, dtype: torch.dtype):
    """Rows q0.. of the attention output from their queries ``qc``
    (B, Hkv, rep, n, D) and float32 keys and values (B, Hkv, S, D)."""
    S = kf.shape[2]
    s = torch.einsum("bkrqd,bksd->bkrqs", qc.float(), kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(q0, q0 + qc.shape[3], device=qc.device)
    kpos = torch.arange(S, device=qc.device)
    mask = torch.ones((qc.shape[3], S), dtype=torch.bool, device=qc.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkrqs,bksd->bkrqd", p, vf)
    return (o / l.clamp_min(1e-30)).to(dtype)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None,
                      softcap: float | None = None,
                      block_q: int = 512, remat: bool = False):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0.
    Returns (B, Hq, S, D) in q's dtype."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"chunked_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    rep = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    block_q = max(min(block_q, S), 1)
    # GQA without materialising repeated KV: fold rep into the batch dims
    qg = q.reshape(B, Hkv, rep, S, D)
    kf, vf = k.float(), v.float()
    remat = remat and torch.is_grad_enabled()
    outs = []
    for q0 in range(0, S, block_q):
        args = (qg[:, :, :, q0:q0 + block_q], kf, vf, q0, causal, window,
                softcap, scale, q.dtype)
        outs.append(checkpoint(_chunk, *args, use_reentrant=False,
                               preserve_rng_state=False) if remat
                    else _chunk(*args))
    out = torch.cat(outs, dim=3) if outs else torch.empty_like(qg)
    return out.reshape(B, Hq, S, D)


def chunked_attention_vjp(q, k, v, g, *, causal: bool = True,
                          window: int | None = None,
                          softcap: float | None = None,
                          block_q: int = 512):
    """Gradients (dq, dk, dv) of ``chunked_attention`` at (q, k, v) against
    the output cotangent ``g``: autograd through the chunked function
    recomputed from q, k and v, each query chunk under
    ``torch.utils.checkpoint``, so no more than one chunk's tiles are
    alive at a time. Reads no forward output: the kernel's forward and its
    plain version share this backward bit for bit."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = chunked_attention(*leaves, causal=causal, window=window,
                                softcap=softcap, block_q=block_q, remat=True)
        return torch.autograd.grad(out, leaves, g)
