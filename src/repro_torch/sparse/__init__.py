"""Sparse substrate of the port (mirrors ``repro.sparse``): segment
reductions and COO utilities, EmbeddingBag, SpMM/SDDMM/gather-scatter and
the host neighbor sampler. It backs the multicut solver (fixed-order
segment sums) and the GNN and recsys families (``scatter_sum``)."""
from repro_torch.sparse.embedding_bag import (
    embedding_bag, embedding_bag_ragged,
)
from repro_torch.sparse.sampler import CSRGraph, NeighborSampler
from repro_torch.sparse.segment_ops import (
    canonical_edge_key, coo_dedupe_sum, scatter_sum, segment_argmax,
    segment_max, segment_mean, segment_min, segment_softmax, segment_sum,
)
from repro_torch.sparse.spmm import gather_scatter_mp, sddmm, spmm

__all__ = [
    "segment_sum", "segment_max", "segment_min", "segment_mean",
    "segment_softmax", "segment_argmax", "scatter_sum", "coo_dedupe_sum",
    "canonical_edge_key", "embedding_bag", "embedding_bag_ragged", "spmm",
    "sddmm", "gather_scatter_mp", "NeighborSampler", "CSRGraph",
]
