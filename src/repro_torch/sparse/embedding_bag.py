"""EmbeddingBag as a gather plus a sum over each bag (port of
``repro.sparse.embedding_bag``).

The fixed-shape variant: each bag has up to ``bag`` slots with a validity
mask (the ragged offsets layout is converted by the host pipeline); the
ragged variant takes a flat index list with a bag id per index. The
gather is ``torch.nn.functional.embedding``, whose gradient is a dense
tensor shaped like the table (as the reference's is).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sparse.segment_ops import scatter_sum


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  mask: torch.Tensor | None = None, mode: str = "sum"
                  ) -> torch.Tensor:
    """Lookup-and-reduce.

    table:   (vocab, dim)
    indices: (..., bag) int32 or int64 indices into the table, padded
    mask:    (..., bag) bool validity of each slot (None = all valid)
    returns: (..., dim); a bag with no valid slot gives 0 in every mode
    """
    emb = F.embedding(indices, table)                 # (..., bag, dim)
    if mask is not None:
        emb = emb * mask[..., None].to(emb.dtype)
    if mode == "sum":
        return emb.sum(-2)
    if mode == "mean":
        if mask is None:
            return emb.mean(-2)
        cnt = torch.clamp(mask.sum(-1, keepdim=True), min=1).to(emb.dtype)
        return emb.sum(-2) / cnt
    if mode == "max":
        if mask is not None:
            emb = torch.where(mask[..., None], emb,
                              torch.full_like(emb, float("-inf")))
        out = emb.amax(-2)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(f"unknown mode {mode}")


def embedding_bag_ragged(table: torch.Tensor, flat_indices: torch.Tensor,
                         bag_ids: torch.Tensor, num_bags: int
                         ) -> torch.Tensor:
    """Ragged variant: flat index list + per-index bag id (offsets
    layout), summed per bag. Matches ``torch.nn.EmbeddingBag(mode=sum)``."""
    return scatter_sum(F.embedding(flat_indices, table), bag_ids, num_bags)
