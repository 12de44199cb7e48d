"""Wrapper of the flash-attention kernel: q (B, Hq, S, D), k and v
(B, Hkv, S, D) in, (B, Hq, S, D) out.

Routes by backend and device: ``backend="reference"`` or a CPU tensor runs
the plain version (``chunked.chunked_attention``); a CUDA tensor with the
default ``backend="cuda"`` launches the hand-written kernel
(``csrc/flash_attention.cu``) through ``_build.Launcher`` or raises — on a
dtype other than bf16, a head dim outside ``SUPPORTED_D``, a build or a
launch error. Nothing falls back quietly. ``flash_attention`` is forward
only: a call that would need a gradient raises and names
``flash_attention_trainable``, the differentiable op (the JAX
``flash_attention_trainable`` / ``make_flash_vjp_op``): its forward is
``flash_attention`` on the same route, its backward
``chunked.chunked_attention_vjp``, which recomputes from q, k and v and
never reads the forward's output, so the kernel route's gradients equal
the plain route's bit for bit.

``launches`` counts kernel launches and nothing else adds to it (a
trainable forward that a checkpointed layer reruns in its backward
launches again); ``shapes`` counts ``(B, Hq, Hkv, S, D, window)`` of each
nonempty call on either device, so a run can show which shapes its path
gave the kernel. Unlike the TPU wrapper, S need not be a multiple of a
block: the kernel masks keys and rows past S itself.

The kernel reads q, k and v by TMA through their strides (only the last
dim must be contiguous; ``_aligned`` copies what TMA cannot read in
place), and writes its output in (B, S, Hq, D) memory order returned as
a (B, Hq, S, D) view, so the transformer's head merge after it is a free
reshape.
"""
from __future__ import annotations

import struct
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.chunked import (
    chunked_attention, chunked_attention_vjp,
)

BACKENDS = ("cuda", "reference")
SUPPORTED_D = (96, 128, 256)

launches = 0
shapes: Counter = Counter()
_fwd = _build.Launcher("flash_attention", "flash_attention_fwd")


def _f32_bits(x: float) -> int:
    """The float32 bit pattern of ``x`` as a signed 32-bit integer."""
    return struct.unpack("<i", struct.pack("<f", x))[0]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself when the kernel's TMA loads can read it in place (a
    contiguous last dim; the other strides positive multiples of 8
    elements, 16 bytes, on every axis longer than 1; a 16-byte aligned
    base), else a contiguous copy."""
    if x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
            s % 8 == 0 and (s > 0 or n == 1)
            for s, n in zip(x.stride()[:-1], x.shape[:-1])):
        return x
    return x.contiguous()


def _launch(q, k, v, causal, window, softcap) -> torch.Tensor:
    global launches
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: the kernel takes bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in SUPPORTED_D:
        raise ValueError(f"flash_attention: head dim {D} not supported by "
                         f"the kernel (supported: {SUPPORTED_D})")
    if B * Hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {B * Hq} exceeds the "
                         f"grid's 65535")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty((B, S, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B == 0 or S == 0 or Hq == 0:
        return out
    _fwd(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         out.data_ptr(), B, Hq, Hkv, S, D,
         *(s for x in (q, k, v, out) for s in x.stride()[:3]), int(causal),
         0 if window is None else int(window),
         _f32_bits(0.0 if softcap is None else float(softcap)),
         _f32_bits(1.0 / D ** 0.5))
    launches += 1
    return out


def _check(name, q, k, v, window, softcap, backend):
    if backend not in BACKENDS:
        raise ValueError(f"{name}: unknown backend {backend!r} "
                         f"(one of {BACKENDS})")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[::3] != k.shape[::3] or q.shape[2] != k.shape[2] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"{name}: need q (B, Hq, S, D) and k, v "
                         f"(B, Hkv, S, D) with Hq % Hkv == 0, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"{name}: softcap must be > 0, got {softcap}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    softcap: float | None = None,
                    backend: str = "cuda") -> torch.Tensor:
    """Softmax attention forward with GQA (q head h reads kv head
    h // (Hq / Hkv)), an optional causal mask, sliding window (keys in
    [i - window + 1, i]) and tanh logit softcap."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only; a call that needs a gradient "
            "goes through flash_attention_trainable")
    _check("flash_attention", q, k, v, window, softcap, backend)
    if backend == "reference":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    B, Hq, S, D = q.shape
    if q.numel():
        shapes[(B, Hq, k.shape[1], S, D, window)] += 1
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, window, softcap)


class _FlashTrainable(torch.autograd.Function):
    """Forward: ``flash_attention`` on the caller's route (autograd is off
    inside, so it takes grad-requiring inputs). Backward: the chunked
    recompute from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, backend, block_q):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        block_q=block_q)
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, backend=backend)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = chunked_attention_vjp(q, k, v, g, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_trainable(q, k, v, *, causal: bool = True,
                              window: int | None = None,
                              softcap: float | None = None,
                              backend: str = "cuda",
                              block_q: int = 512) -> torch.Tensor:
    """Differentiable ``flash_attention``: the same forward (the kernel on
    a CUDA tensor with ``backend="cuda"``, else the plain version) and a
    backward that recomputes ``chunked_attention`` from q, k and v one
    query chunk of ``block_q`` at a time."""
    _check("flash_attention_trainable", q, k, v, window, softcap, backend)
    return _FlashTrainable.apply(q, k, v, causal, window, softcap, backend,
                                 block_q)
