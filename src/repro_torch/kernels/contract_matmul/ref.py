"""Plain PyTorch versions of the contraction product (Lemma 4): the oracle
the ``contract_matmul`` kernel is held to. Products run in full float32:
TF32 is switched off for their duration, whatever the caller set.

``tf32_round`` and ``matmul_3xtf32`` write the kernel's arithmetic out in
torch (the hi/lo split and the three TF32 products), so the CPU tests can
hold it against the plain version; no route of the wrapper runs them."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Float32 matrix products without TF32 (restores the caller's
    setting)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def one_hot(f: torch.Tensor, n_new: int,
            dtype=torch.float32) -> torch.Tensor:
    """(N, n_new) one-hot rows of ``f``; an id outside [0, n_new) gives a
    zero row, as ``jax.nn.one_hot`` does (torch's own raises)."""
    cols = torch.arange(n_new, device=f.device)
    return (f.long()[:, None] == cols[None, :]).to(dtype)


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y in float32 with float32 accumulation."""
    with full_fp32():
        return torch.matmul(x.to(torch.float32), y.to(torch.float32))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (a 10-bit mantissa), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: half a TF32 ulp is added
    to the magnitude bits of the float32 view, and the 13 low bits are
    cleared. Infinities and NaNs pass through."""
    x = x.to(torch.float32).contiguous()
    bits = (x.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x) and lo = tf32(x − hi), the kernel's
    split pass."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_3xtf32(x: torch.Tensor, y: torch.Tensor,
                  passes: int = 3) -> torch.Tensor:
    """x @ y as the kernel computes it: lo·hi + hi·lo + hi·hi of the TF32
    splits, into one float32 accumulator (each product of two TF32 values
    is exact in float32). ``passes=1`` keeps hi·hi alone: a single TF32
    product, which the 1e-5 gate must reject."""
    xh, xl = split_tf32(x)
    yh, yl = split_tf32(y)
    with full_fp32():
        if passes == 1:
            return torch.matmul(xh, yh)
        out = torch.matmul(xl, yh)
        out += torch.matmul(xh, yl)
        out += torch.matmul(xh, yh)
    return out


def contract_matmul_ref(A: torch.Tensor, f: torch.Tensor, n_new: int,
                        drop_diag: bool = True) -> torch.Tensor:
    """A' = KᵀAK (optionally minus its diagonal) with K = one_hot(f)."""
    K = one_hot(f, n_new, A.dtype)
    M = matmul_ref(matmul_ref(K.T, A), K)
    if drop_diag:
        M = M - torch.diag(torch.diag(M))
    return M
