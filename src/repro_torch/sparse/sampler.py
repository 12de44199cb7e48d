"""Host-side neighbor sampler for minibatch GNN training (GraphSAGE-style);
the port's own copy of ``repro.sparse.sampler`` (host numpy: the same
``np.random.default_rng((seed, step))`` draws, so the same seed and step
give identical blocks).

``minibatch_lg`` (232k nodes / 114M edges, batch_nodes=1024, fanout 15-10)
needs a real sampler: the device step consumes fixed-shape sampled blocks;
raggedness is resolved on the host with numpy. The sampler is seeded and
stateless per step (step -> batch), which makes checkpoint-restart exactly
resumable.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class CSRGraph(NamedTuple):
    """Host-side CSR adjacency for sampling."""
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (nnz,)

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> "CSRGraph":
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        counts = np.bincount(src_s, minlength=num_nodes)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr=indptr, indices=dst_s.astype(np.int32))


class SampledBlock(NamedTuple):
    """One hop of a sampled computation block (fixed shapes)."""
    src: np.ndarray    # (n_dst * fanout,) int32 — global ids, padded w/ self
    dst: np.ndarray    # (n_dst * fanout,) int32 — local dst slot per edge
    mask: np.ndarray   # (n_dst * fanout,) bool
    dst_nodes: np.ndarray  # (n_dst,) int32 global ids of the dst frontier


class NeighborSampler:
    """Multi-hop uniform neighbor sampler with fixed fanouts."""

    def __init__(self, graph: CSRGraph, fanouts: Sequence[int], seed: int = 0):
        self.graph = graph
        self.fanouts = tuple(fanouts)
        self.seed = seed

    def sample(self, seed_nodes: np.ndarray, step: int) -> list[SampledBlock]:
        """Sample blocks from seeds outward; blocks[0] is the outermost hop.

        Each block's ``src`` holds *global* node ids of sampled neighbors,
        ``dst`` the local index of the frontier node each edge points to.
        """
        rng = np.random.default_rng((self.seed, step))
        blocks: list[SampledBlock] = []
        frontier = seed_nodes.astype(np.int32)
        for fanout in self.fanouts:
            n_dst = len(frontier)
            src = np.empty(n_dst * fanout, dtype=np.int32)
            dst = np.repeat(np.arange(n_dst, dtype=np.int32), fanout)
            mask = np.zeros(n_dst * fanout, dtype=bool)
            for i, node in enumerate(frontier):
                lo, hi = self.graph.indptr[node], self.graph.indptr[node + 1]
                deg = hi - lo
                sl = slice(i * fanout, (i + 1) * fanout)
                if deg == 0:
                    src[sl] = node  # self-padding, masked out
                    continue
                if deg <= fanout:
                    neigh = self.graph.indices[lo:hi]
                    src[i * fanout: i * fanout + deg] = neigh
                    src[i * fanout + deg: (i + 1) * fanout] = node
                    mask[i * fanout: i * fanout + deg] = True
                else:
                    pick = rng.integers(lo, hi, size=fanout)
                    src[sl] = self.graph.indices[pick]
                    mask[sl] = True
            blocks.append(SampledBlock(src=src, dst=dst, mask=mask,
                                       dst_nodes=frontier.copy()))
            # next frontier: union of dst frontier and sampled srcs
            frontier = np.unique(np.concatenate([frontier, src[mask]])).astype(np.int32)
        blocks.reverse()  # outermost hop first
        return blocks

    def sample_padded(self, seed_nodes: np.ndarray, step: int,
                      max_nodes_per_hop: Sequence[int]) -> dict:
        """Fixed-shape variant for a device step: relabels global ids into
        a compact [0, total_nodes) space and pads every hop to its static
        budget.

        Returns dict of numpy arrays consumable by a fixed-shape GNN step:
          node_ids   (n_total,) global ids (padded with 0)
          node_mask  (n_total,)
          hop_src/hop_dst/hop_mask per hop, local indices into node_ids.
        """
        blocks = self.sample(seed_nodes, step)
        all_nodes = np.unique(np.concatenate(
            [seed_nodes.astype(np.int32)] + [b.src[b.mask] for b in blocks] +
            [b.dst_nodes for b in blocks]))
        n_total = int(sum(max_nodes_per_hop))
        if len(all_nodes) > n_total:
            raise ValueError(f"sampled {len(all_nodes)} nodes > budget {n_total}")
        lookup = {g: i for i, g in enumerate(all_nodes)}
        node_ids = np.zeros(n_total, dtype=np.int32)
        node_ids[: len(all_nodes)] = all_nodes
        node_mask = np.zeros(n_total, dtype=bool)
        node_mask[: len(all_nodes)] = True
        out = {"node_ids": node_ids, "node_mask": node_mask,
               "seed_local": np.array([lookup[g] for g in seed_nodes], dtype=np.int32)}
        for h, b in enumerate(blocks):
            src_l = np.array([lookup.get(g, 0) for g in b.src], dtype=np.int32)
            dst_l = np.array([lookup[g] for g in b.dst_nodes], dtype=np.int32)[b.dst]
            out[f"hop{h}_src"] = src_l
            out[f"hop{h}_dst"] = dst_l
            out[f"hop{h}_mask"] = b.mask.copy()
        return out
