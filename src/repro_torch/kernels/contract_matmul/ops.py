"""Wrapper of the contract_matmul kernel: a float32 ``x @ y`` with float32
results and an optional zero-diagonal epilogue, and the contraction
product built from two of its launches.

Routes by the tensors' device: CUDA tensors launch the hand-written kernels
(``csrc/contract_matmul.cu``) or raise; CPU tensors run the plain version
(``ref.matmul_ref``). Nothing falls back quietly. On the card a product is
three launches: two split passes write each operand's TF32 hi and lo planes
(K-major, into scratch from ``torch.empty``), then the product kernel runs
the three TF32 products on the tensor cores (3xTF32). ``launches`` counts
product launches only (two per contraction); ``split_launches`` counts the
split passes; ``shapes`` counts the (M, K, N) of each nonempty call on
either device. There is no tile padding: the kernels mask their ragged
edges, and the split reads its operand through its strides, so a
transposed view (Kᵀ) costs no extra copy.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.contract_matmul.ref import matmul_ref, one_hot

launches = 0
split_launches = 0
shapes: Counter = Counter()

_split = _build.Launcher("contract_matmul", "contract_matmul_split")
_product = _build.Launcher("contract_matmul", "contract_matmul_product")


def _drop_diagonal(out: torch.Tensor) -> torch.Tensor:
    n = min(out.shape)
    idx = torch.arange(n, device=out.device)
    out[idx, idx] = 0.0
    return out


def _planes(a: torch.Tensor, rows: int, K: int, s_row: int,
            s_k: int) -> torch.Tensor:
    """(2, rows, Kp) TF32 hi and lo planes of the (rows, K) operand that
    ``a``'s storage holds at element strides (s_row, s_k); Kp = K rounded
    up to 4 floats, the pad zeroed."""
    global split_launches
    Kp = (K + 3) // 4 * 4
    planes = torch.empty((2, rows, Kp), dtype=torch.float32, device=a.device)
    _split(a.device.index, a.data_ptr(), planes.data_ptr(), rows, K, Kp,
           s_row, s_k)
    split_launches += 1
    return planes


def matmul(x: torch.Tensor, y: torch.Tensor,
           drop_diag: bool = False) -> torch.Tensor:
    """(M, K) @ (K, N) float32 → (M, N) float32, contiguous. ``drop_diag``
    zeroes the entries whose global row equals their global column."""
    global launches
    if x.device != y.device:
        raise ValueError(f"matmul: x on {x.device}, y on {y.device}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: need (M, K) and (K, N), got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    M, K = x.shape
    N = y.shape[1]
    if x.device.type == "cpu":
        if M and N and K:
            shapes[(M, K, N)] += 1
        out = matmul_ref(x, y)
        return _drop_diagonal(out) if drop_diag else out
    if x.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {x.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(f"matmul: need float32, got {x.dtype} and "
                         f"{y.dtype}")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    xp = _planes(x, M, K, x.stride(0), x.stride(1))
    yp = _planes(y, N, K, y.stride(1), y.stride(0))     # yᵀ, K-major
    _product(x.device.index, xp.data_ptr(), yp.data_ptr(), out.data_ptr(),
             M, N, K, xp.shape[2], int(drop_diag))
    launches += 1
    shapes[(M, K, N)] += 1
    return out


def contract_matmul(A: torch.Tensor, f: torch.Tensor,
                    n_new: int) -> torch.Tensor:
    """A: (N, N) adjacency; f: (N,) contraction mapping into [0, n_new).
    Returns the (n_new, n_new) contracted adjacency KᵀAK with a zero
    diagonal, K = one_hot(f): B = A @ K, then Kᵀ @ B with the diagonal
    dropped in the epilogue — two product launches on the card."""
    K = one_hot(f, n_new, torch.float32)
    B = matmul(A, K)
    return matmul(K.T, B, drop_diag=True)
