"""Plain PyTorch versions of the contraction product (Lemma 4): the oracle
the ``contract_matmul`` kernel is held to. Products run in full float32:
TF32 is switched off for their duration, whatever the caller set."""
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


def contract_matmul_ref(A: torch.Tensor, f: torch.Tensor, n_new: int,
                        drop_diag: bool = True) -> torch.Tensor:
    """A' = KᵀAK (optionally minus its diagonal) with K = one_hot(f)."""
    K = one_hot(f, n_new, A.dtype)
    M = matmul_ref(matmul_ref(K.T, A), K)
    if drop_diag:
        M = M - torch.diag(torch.diag(M))
    return M
