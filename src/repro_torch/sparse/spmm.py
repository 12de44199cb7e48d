"""Edge-index message passing primitives: SpMM, SDDMM, gather-scatter
(port of ``repro.sparse.spmm``).

GNN message passing is a gather (``index_select``) over an edge index
followed by a segment reduction over the destinations. The sums are
:func:`repro_torch.sparse.segment_ops.scatter_sum`: one ``index_add``,
whose order on CUDA is not fixed (they feed no discrete decision; see
the segment_ops module note).
"""
from __future__ import annotations

import torch

from repro_torch.sparse.segment_ops import scatter_sum, segment_max


def spmm(src: torch.Tensor, dst: torch.Tensor, edge_w: torch.Tensor | None,
         x: torch.Tensor, num_nodes: int, reduce: str = "sum"
         ) -> torch.Tensor:
    """y[i] = reduce_{(j -> i) in E} w_ji * x[j].

    src, dst: (E,) int32 edge endpoints (messages flow src -> dst)
    edge_w:   (E,) weights or None
    x:        (N, d) node features
    Nodes that receive no message get 0 under every reduction.
    """
    msg = x.index_select(0, src)                      # (E, d)
    if edge_w is not None:
        msg = msg * edge_w[:, None].to(msg.dtype)
    if reduce == "sum":
        return scatter_sum(msg, dst, num_nodes)
    if reduce == "max":
        out = segment_max(msg, dst, num_nodes)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    if reduce == "mean":
        tot = scatter_sum(msg, dst, num_nodes)
        cnt = scatter_sum(torch.ones(dst.shape, dtype=msg.dtype,
                                     device=msg.device), dst, num_nodes)
        return tot / torch.clamp(cnt, min=1.0)[:, None]
    raise ValueError(reduce)


def sddmm(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul: per-edge dot products a[src] . b[dst]."""
    return (a.index_select(0, src) * b.index_select(0, dst)).sum(-1)


def gather_scatter_mp(src, dst, edge_feat, x, msg_fn, num_nodes: int):
    """Generic MPNN step: msg = msg_fn(x[src], x[dst], edge_feat) ->
    scatter-sum over the destinations."""
    msg = msg_fn(x.index_select(0, src), x.index_select(0, dst), edge_feat)
    return scatter_sum(msg, dst, num_nodes)
