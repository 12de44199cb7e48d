"""Memory-efficient chunked attention (Rabe & Staats), forward only: the
plain PyTorch version of the flash kernel (port of the JAX package's
``chunked.py::chunked_attention``; off the TPU it is what the JAX
transformer runs with ``use_flash=True``).

One (B, Hkv, rep, block_q, S) float32 score tile at a time. Logits and
the softmax are float32 (q scaled after the product, as the JAX function
does); each chunk's output is rounded to q's dtype. The JAX function pads
S up to a multiple of ``block_q``; here the last chunk is simply shorter,
which gives the same rows. The custom-vjp pairing with the kernel
(``make_flash_vjp_op``) waits for training (ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None,
                      softcap: float | None = None,
                      block_q: int = 512):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0.
    Returns (B, Hq, S, D) in q's dtype."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"chunked_attention: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    rep = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    block_q = min(block_q, S)
    # GQA without materialising repeated KV: fold rep into the batch dims
    qg = q.reshape(B, Hkv, rep, S, D)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(S, device=q.device)
    out = torch.empty_like(qg)
    for q0 in range(0, S, block_q):
        qc = qg[:, :, :, q0:q0 + block_q].float()
        s = torch.einsum("bkrqd,bksd->bkrqs", qc, kf) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        qpos = torch.arange(q0, q0 + qc.shape[3], device=q.device)
        mask = torch.ones((qc.shape[3], S), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkrqs,bksd->bkrqd", p, vf)
        out[:, :, :, q0:q0 + block_q] = (o / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(B, Hq, S, D)
