"""Sequential CPU baselines from the paper's experiment section (a copy of
``repro.core.baselines`` for the port's instance type).

These are deliberately host-side (numpy + heaps): GAEC/GEF/BEC/KLj/ICP are
the *sequential CPU* algorithms RAMA is compared against (paper Table 1), so
a Python implementation is the faithful baseline-side artifact. Brute force
enumerates set partitions for ≤ ~10 nodes and anchors every correctness test.

Each function pulls the instance's tensors to the host once, through
:func:`repro_torch.core.graph.to_host_edges` (int32 ids, float32 costs, as
the reference's arrays), so the heaps see the same keys in the same order
and the labels equal the reference's exactly.
"""
from __future__ import annotations

import heapq
from collections import defaultdict

import numpy as np

from repro_torch.core.graph import MulticutInstance, to_host_edges


# ---------------------------------------------------------------------------
# shared machinery
# ---------------------------------------------------------------------------

class _UnionFind:
    def __init__(self, n):
        self.parent = list(range(n))
        self.size = [1] * n

    def find(self, x):
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        return ra


def _adjacency(u, v, c, n):
    adj = [defaultdict(float) for _ in range(n)]
    for a, b, w in zip(u.tolist(), v.tolist(), c.tolist()):
        adj[a][b] += w
        adj[b][a] += w
    return adj


def labels_from_uf(uf: "_UnionFind", n: int) -> np.ndarray:
    roots = {}
    lab = np.empty(n, dtype=np.int32)
    for i in range(n):
        r = uf.find(i)
        lab[i] = roots.setdefault(r, len(roots))
    return lab


def objective(inst: MulticutInstance, labels: np.ndarray) -> float:
    u, v, c = to_host_edges(inst)
    return float(np.sum(c[labels[u] != labels[v]]))


# ---------------------------------------------------------------------------
# GAEC — greedy additive edge contraction [30]
# ---------------------------------------------------------------------------

def gaec(inst: MulticutInstance) -> np.ndarray:
    u, v, c = to_host_edges(inst)
    n = inst.num_nodes
    adj = _adjacency(u, v, c, n)
    uf = _UnionFind(n)
    heap = [(-w, a, b) for a in range(n) for b, w in adj[a].items()
            if a < b and w > 0]
    heapq.heapify(heap)
    while heap:
        negw, a, b = heapq.heappop(heap)
        ra, rb = uf.find(a), uf.find(b)
        if ra == rb:
            continue
        # stale-entry check: current cost between the two clusters
        w = adj[ra].get(rb, 0.0)
        if -negw != w:
            if w > 0:
                heapq.heappush(heap, (-w, ra, rb))
            continue
        if w <= 0:
            continue
        # contract rb into ra (or merged root)
        r = uf.union(ra, rb)
        other = rb if r == ra else ra
        for nb, wv in list(adj[other].items()):
            if nb == r:
                continue
            adj[nb].pop(other, None)
            adj[r][nb] = adj[r].get(nb, 0.0) + wv
            adj[nb][r] = adj[r][nb]
            if adj[r][nb] > 0:
                heapq.heappush(heap, (-adj[r][nb], min(r, nb), max(r, nb)))
        adj[r].pop(other, None)
        adj[other].clear()
    return labels_from_uf(uf, n)


# ---------------------------------------------------------------------------
# BEC — balanced edge contraction [28]: priority normalised by cluster sizes
# ---------------------------------------------------------------------------

def bec(inst: MulticutInstance) -> np.ndarray:
    u, v, c = to_host_edges(inst)
    n = inst.num_nodes
    adj = _adjacency(u, v, c, n)
    uf = _UnionFind(n)

    def prio(w, a, b):
        return -w / (uf.size[a] + uf.size[b])

    heap = [(prio(w, a, b), w, a, b) for a in range(n)
            for b, w in adj[a].items() if a < b and w > 0]
    heapq.heapify(heap)
    while heap:
        p, w0, a, b = heapq.heappop(heap)
        ra, rb = uf.find(a), uf.find(b)
        if ra == rb:
            continue
        w = adj[ra].get(rb, 0.0)
        if w <= 0:
            continue
        cur_p = prio(w, ra, rb)
        if abs(cur_p - p) > 1e-12 or w0 != w:
            heapq.heappush(heap, (cur_p, w, ra, rb))
            continue
        r = uf.union(ra, rb)
        other = rb if r == ra else ra
        for nb, wv in list(adj[other].items()):
            if nb == r:
                continue
            adj[nb].pop(other, None)
            adj[r][nb] = adj[r].get(nb, 0.0) + wv
            adj[nb][r] = adj[r][nb]
            if adj[r][nb] > 0:
                heapq.heappush(heap, (prio(adj[r][nb], r, nb), adj[r][nb],
                                      r, nb))
        adj[r].pop(other, None)
        adj[other].clear()
    return labels_from_uf(uf, n)


# ---------------------------------------------------------------------------
# GEF — greedy edge fixation [40]: contraction + repulsive non-link fixing
# ---------------------------------------------------------------------------

def gef(inst: MulticutInstance) -> np.ndarray:
    u, v, c = to_host_edges(inst)
    n = inst.num_nodes
    adj = _adjacency(u, v, c, n)
    uf = _UnionFind(n)
    forbidden: set[tuple[int, int]] = set()

    def fkey(a, b):
        return (min(a, b), max(a, b))

    heap = [(-abs(w), a, b) for a in range(n) for b, w in adj[a].items()
            if a < b and w != 0]
    heapq.heapify(heap)
    while heap:
        nw, a, b = heapq.heappop(heap)
        ra, rb = uf.find(a), uf.find(b)
        if ra == rb:
            continue
        w = adj[ra].get(rb, 0.0)
        if abs(w) != -nw:
            if w != 0:
                heapq.heappush(heap, (-abs(w), ra, rb))
            continue
        if w > 0:
            if fkey(ra, rb) in forbidden:
                continue
            r = uf.union(ra, rb)
            other = rb if r == ra else ra
            for nb, wv in list(adj[other].items()):
                if nb == r:
                    continue
                adj[nb].pop(other, None)
                adj[r][nb] = adj[r].get(nb, 0.0) + wv
                adj[nb][r] = adj[r][nb]
                if fkey(other, nb) in forbidden:
                    forbidden.add(fkey(r, nb))
                if adj[r][nb] != 0:
                    heapq.heappush(heap, (-abs(adj[r][nb]), r, nb))
            adj[r].pop(other, None)
            adj[other].clear()
        else:
            forbidden.add(fkey(ra, rb))
    return labels_from_uf(uf, n)


# ---------------------------------------------------------------------------
# ICP — iterated cycle packing [38]: greedy dual lower bound
# ---------------------------------------------------------------------------

def icp(inst: MulticutInstance, max_passes: int = 5,
        max_path_len: int = 5) -> float:
    """Greedy conflicted-cycle packing: hop-shortest attractive path per
    repulsive edge, pack w = min(|c_f|, min path residual). LB = Σ min(0, c)
    over residual costs; each packed cycle improves it by +w."""
    u, v, c = to_host_edges(inst)
    n = inst.num_nodes
    res = defaultdict(float)
    for a, b, w in zip(u.tolist(), v.tolist(), c.tolist()):
        res[(min(a, b), max(a, b))] += w
    adj = defaultdict(set)
    for (a, b) in res:
        adj[a].add(b)
        adj[b].add(a)

    def bfs_path(src, dst):
        # hop-shortest path using only residual-positive edges
        prev = {src: src}
        frontier = [src]
        depth = 0
        while frontier and depth < max_path_len:
            nxt = []
            for x in frontier:
                for y in adj[x]:
                    if y in prev:
                        continue
                    w = res.get((min(x, y), max(x, y)), 0.0)
                    if w <= 1e-12:
                        continue
                    prev[y] = x
                    if y == dst:
                        path = [y]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return path[::-1]
                    nxt.append(y)
            frontier = nxt
            depth += 1
        return None

    for _ in range(max_passes):
        improved = False
        neg_edges = sorted([e for e, w in res.items() if w < -1e-12],
                           key=lambda e: res[e])
        for (a, b) in neg_edges:
            wf = res[(a, b)]
            if wf >= -1e-12:
                continue
            path = bfs_path(a, b)
            if path is None:
                continue
            pe = [(min(x, y), max(x, y)) for x, y in zip(path, path[1:])]
            wcap = min(-wf, min(res[e] for e in pe))
            if wcap <= 1e-12:
                continue
            for e in pe:
                res[e] -= wcap
            res[(a, b)] += wcap
            improved = True
        if not improved:
            break
    return float(sum(w for w in res.values() if w < 0))


# ---------------------------------------------------------------------------
# Brute force (test oracle)
# ---------------------------------------------------------------------------

def brute_force(inst: MulticutInstance) -> tuple[float, np.ndarray]:
    """Exact minimum over all set partitions (restricted growth strings)."""
    n = int(inst.node_valid.sum())
    assert n <= 11, "brute force limited to tiny instances"
    u, v, c = to_host_edges(inst)
    best = (float("inf"), None)

    def gen(prefix, m):
        if len(prefix) == n:
            yield prefix
            return
        for k in range(m + 1):
            yield from gen(prefix + [k], max(m, k + 1))

    for assign in gen([0], 1):
        lab = np.array(assign)
        obj = float(np.sum(c[lab[u] != lab[v]]))
        if obj < best[0]:
            best = (obj, lab.copy())
    return best


def greedy_join_local_search(inst: MulticutInstance,
                             labels: np.ndarray) -> np.ndarray:
    """KLj-lite: repeated greedy cluster-join moves that decrease the
    objective (the 'join' move class of Kernighan–Lin with joins [30])."""
    u, v, c = to_host_edges(inst)
    labels = labels.copy()
    while True:
        inter = defaultdict(float)
        for a, b, w in zip(labels[u].tolist(), labels[v].tolist(), c.tolist()):
            if a != b:
                inter[(min(a, b), max(a, b))] += w
        best = max(inter.items(), key=lambda kv: kv[1], default=None)
        if best is None or best[1] <= 1e-12:
            break
        (la, lb), _ = best
        labels[labels == lb] = la
    return labels
