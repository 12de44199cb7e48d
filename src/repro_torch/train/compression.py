"""int8 error-feedback gradient compression (port of the JAX package's
``train/compression.py``).

Each leaf is quantised to int8 with one symmetric scale (its max |value|
over 127), and the quantisation residual is kept in an error-feedback
buffer that is added to the next step's gradient, so the bias cancels
over steps. ``fake_quantize_ef`` applies the quantisation in place of an
int8 all-reduce: its result is what such a reduce delivers (up to the
summation order). ``torch.round`` rounds half to even as ``jnp.round``
does, so the int8 codes equal the JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def quantize_leaf(g: torch.Tensor):
    """int8 symmetric quantisation; returns (q, scale)."""
    amax = g.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def fake_quantize_ef(grads, err):
    """Error-feedback int8 quantisation applied leaf-wise. Returns
    (quantised grads in each grad's dtype, new error buffers)."""
    def leaf(g, e):
        corrected = g + e
        q, scale = quantize_leaf(corrected)
        deq = dequantize_leaf(q, scale)
        return deq.to(g.dtype), (corrected - deq).to(g.dtype)

    pairs = tree_map(leaf, grads, err)
    return (tree_map(lambda g, p: p[0], grads, pairs),
            tree_map(lambda g, p: p[1], grads, pairs))


def init_error_buffers(params):
    return tree_map(torch.zeros_like, params)
