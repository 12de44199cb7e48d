"""Wrapper of the contract_matmul kernel: a float32 ``x @ y`` with float32
accumulation and an optional zero-diagonal epilogue, and the contraction
product built from two of its launches.

Routes by the tensors' device: CUDA tensors launch the hand-written kernel
(``csrc/contract_matmul.cu``) or raise; CPU tensors run the plain version
(``ref.matmul_ref``). Nothing falls back quietly. ``launches`` counts
kernel launches and nothing else; ``shapes`` counts the (M, K, N) of each
nonempty call on either device. Unlike the TPU wrapper there is no tile
padding: the kernel masks its ragged edges. The kernel reads both inputs
through their strides, so a transposed view (Kᵀ) costs no copy.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.contract_matmul.ref import matmul_ref, one_hot

launches = 0
shapes: Counter = Counter()
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load("contract_matmul")
        fn = lib.contract_matmul_sgemm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def _drop_diagonal(out: torch.Tensor) -> torch.Tensor:
    n = min(out.shape)
    idx = torch.arange(n, device=out.device)
    out[idx, idx] = 0.0
    return out


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
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(lib, fn(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                             M, N, K, x.stride(0), x.stride(1),
                             y.stride(0), y.stride(1), int(drop_diag),
                             stream), "contract_matmul_sgemm")
    launches += 1
    shapes[(M, K, N)] += 1
    return out


def contract_matmul(A: torch.Tensor, f: torch.Tensor,
                    n_new: int) -> torch.Tensor:
    """A: (N, N) adjacency; f: (N,) contraction mapping into [0, n_new).
    Returns the (n_new, n_new) contracted adjacency KᵀAK with a zero
    diagonal, K = one_hot(f): B = A @ K, then Kᵀ @ B with the diagonal
    dropped in the epilogue — two kernel launches on the card."""
    K = one_hot(f, n_new, torch.float32)
    B = matmul(A, K)
    return matmul(K.T, B, drop_diag=True)
