"""Padded-COO multicut instance, padded-CSR graph view + instance generators.

Port of ``repro.core.graph``. The padded shapes stay fixed for the life of
a solve, exactly as in the reference: ``node_valid`` marks live cluster
representatives, ``edge_valid`` live edges. Costs follow the paper's sign
convention: c > 0 attractive (want joined), c < 0 repulsive (want cut).

Tensors live on an explicit device. Entry points default to ``cuda`` and
raise when no card is present; the CPU is used only when a caller asks for
it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

GRAPH_IMPLS = ("dense", "sparse", "auto")

INT32_MAX = 2 ** 31 - 1

# "auto" flips the separation data path to CSR above this padded node
# count (the reference's calibrated crossover, core/graph.py there).
DEFAULT_SPARSE_THRESHOLD = 256

ROW_CAP_FLOOR = 8   # never tune sparse_row_cap_short below this


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. With no card and no explicit device this raises instead of
    quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


# --------------------------------------------------------------------------
# Addressing dtype policy
# --------------------------------------------------------------------------
#
# Node and edge ids are int32, as in the reference. CSR offsets (values run
# to 2E) widen to int64 once 2E exceeds int32. Torch always has int64, so
# the reference's x64-mode error does not apply; what the port cannot
# address yet is an edge id past int32 (a replicated build over > 2^31
# edges), and that raises before anything is built.

def offset_dtype(num_edges: int):
    """Dtype for CSR offsets (values run to 2·num_edges)."""
    return torch.int64 if 2 * num_edges > INT32_MAX else torch.int32


def index_dtype(num_edges: int):
    """Dtype for edge ids (values run to num_edges)."""
    return torch.int64 if num_edges > INT32_MAX else torch.int32


def check_edge_addressing(num_edges: int, where: str = "build_csr") -> None:
    """Raise an actionable ValueError when ``num_edges`` needs edge ids past
    int32, which the port's int32 id arrays would silently wrap."""
    if num_edges <= INT32_MAX:
        return
    raise ValueError(
        f"{where}: {num_edges} edges need int64 edge ids (> int32 max "
        f"{INT32_MAX}); the port keeps edge ids int32 — shard the instance "
        f"so each part holds <= {INT32_MAX} edges.")


class MulticutInstance(NamedTuple):
    u: torch.Tensor            # (E,) int32, u < v for valid edges
    v: torch.Tensor            # (E,) int32
    cost: torch.Tensor         # (E,) float32
    edge_valid: torch.Tensor   # (E,) bool
    node_valid: torch.Tensor   # (N,) bool

    @property
    def num_nodes(self) -> int:
        return self.node_valid.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.cost.device

    def to(self, device) -> "MulticutInstance":
        return type(self)(*(t.to(device) for t in self))

    def objective(self, labels: torch.Tensor) -> torch.Tensor:
        """Multicut objective <c, y>: sum of costs of cut edges under a node
        labeling (y_e = 1 iff endpoints in distinct clusters)."""
        cut = labels[self.u] != labels[self.v]
        return torch.where(self.edge_valid & cut, self.cost,
                           torch.zeros_like(self.cost)).sum()


def make_instance(u, v, cost, num_nodes: int, pad_edges: int | None = None,
                  pad_nodes: int | None = None,
                  device=None) -> MulticutInstance:
    """Build a padded instance from (possibly unordered) host edge arrays.

    Parallel edges are merged by summing their costs, first-occurrence
    order kept. Raises ``ValueError`` on mismatched ``u``/``v``/``cost``
    lengths, node ids outside ``[0, num_nodes)``, or self-loops with nonzero
    cost. Zero-cost self-loops stay admissible (they are the neutral filler
    padding emits). Host code is the reference's numpy, line for line, so
    both packages build the same arrays from the same input."""
    u = np.asarray(u, dtype=np.int32)
    v = np.asarray(v, dtype=np.int32)
    cost = np.asarray(cost, dtype=np.float32)
    if not (u.shape == v.shape == cost.shape and u.ndim == 1):
        raise ValueError(
            f"u/v/cost must be 1-D arrays of equal length; got shapes "
            f"u={u.shape}, v={v.shape}, cost={cost.shape}")
    if len(u) and (u.min() < 0 or v.min() < 0
                   or max(u.max(), v.max()) >= num_nodes):
        bad = np.where((u < 0) | (v < 0) | (u >= num_nodes)
                       | (v >= num_nodes))[0]
        raise ValueError(
            f"node ids must lie in [0, {num_nodes}); {len(bad)} edge(s) out "
            f"of range, first at index {int(bad[0])}: "
            f"({int(u[bad[0]])}, {int(v[bad[0]])})")
    if len(u):
        bad = np.where((u == v) & (cost != 0.0))[0]
        if len(bad):
            raise ValueError(
                f"self-loops must have zero cost (a nonzero self-loop cost "
                f"can never be cut and would silently shift the objective); "
                f"{len(bad)} offending edge(s), first at index "
                f"{int(bad[0])}: ({int(u[bad[0]])}, {int(u[bad[0]])}) with "
                f"cost {float(cost[bad[0]])}")
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    if len(lo):
        pairs = np.stack([lo, hi], axis=1)
        _, first_idx, inv = np.unique(pairs, axis=0, return_index=True,
                                      return_inverse=True)
        if len(first_idx) < len(lo):
            order = np.argsort(first_idx)          # first-occurrence order
            rank = np.empty_like(order)
            rank[order] = np.arange(len(order))
            merged = np.zeros(len(first_idx), dtype=np.float32)
            np.add.at(merged, rank[inv.reshape(-1)], cost)
            keep = first_idx[order]
            lo, hi, cost = lo[keep], hi[keep], merged
    E = len(lo)
    Ep = pad_edges if pad_edges is not None else E
    Np = pad_nodes if pad_nodes is not None else num_nodes
    assert Ep >= E and Np >= num_nodes
    check_edge_addressing(Ep, where="make_instance")
    uu = np.zeros(Ep, dtype=np.int32); uu[:E] = lo
    vv = np.zeros(Ep, dtype=np.int32); vv[:E] = hi
    cc = np.zeros(Ep, dtype=np.float32); cc[:E] = cost
    ev = np.zeros(Ep, dtype=bool); ev[:E] = True
    nv = np.zeros(Np, dtype=bool); nv[:num_nodes] = True
    dev = resolve_device(device)
    return MulticutInstance(*(torch.from_numpy(a).to(dev)
                              for a in (uu, vv, cc, ev, nv)))


def to_host_edges(inst: MulticutInstance):
    """Valid edges as host numpy arrays (u int32, v int32, cost float32),
    in edge-id order: one copy of each leaf to the host."""
    ev = inst.edge_valid.cpu().numpy()
    return (inst.u.cpu().numpy()[ev], inst.v.cpu().numpy()[ev],
            inst.cost.cpu().numpy()[ev])


class StreamStats(NamedTuple):
    """Host-memory accounting of :func:`make_instance_streamed`: the
    ingest never holds more than one edge range plus one chunk of COO on
    a rank's host."""
    n_chunks: int           # COO chunks consumed
    n_edges: int            # valid edges ingested
    peak_host_elems: int    # max host-resident edge slots at any instant
                            # (range buffer + in-flight chunk)


class EdgeRange(MulticutInstance):
    """One rank's contiguous edge range of a padded instance: the rank's
    ``[rank * E/S, (rank+1) * E/S)`` slice of u/v/cost/edge_valid (so
    ``num_edges`` is E/S) and the full node_valid. What
    ``make_instance_streamed(state_shards=S)`` gives each rank of the
    state group, and what :func:`repro_torch.core.sharded.
    solve_state_sharded` takes in place of the full instance (ranks past
    the group hold an empty range)."""
    __slots__ = ()


def make_instance_streamed(chunks, num_nodes: int, pad_edges: int,
                           state_shards: int = 1,
                           pad_nodes: int | None = None, device=None,
                           ) -> tuple[MulticutInstance | EdgeRange,
                                      StreamStats]:
    """Streaming instance ingest: build the padded edge arrays from an
    iterable of COO ``(u, v, cost)`` chunks, so the edge list is never
    materialised a second time on the host.

    ``chunks`` yields host arrays in final edge-id order; the input must be
    **duplicate-free** (merging parallel edges across chunks needs the
    whole list; :func:`make_instance` merges duplicates). Each chunk's
    edges that this rank keeps are validated like ``make_instance``'s (id
    range, self-loop costs).

    ``state_shards`` is resolved like the solver's
    (``dist.resolve_state_shards``: clamped to the default process group's
    ranks, 1 without one). With one shard the edges go into one reusable
    host buffer of ``pad_edges`` slots and the result is the instance.
    With S > 1 each rank of the state group keeps only its own edge range,
    ``pad_edges / S`` slots, skips the chunks outside it, and returns its
    :class:`EdgeRange` for ``solve_state_sharded``; this is one buffer per
    rank on its host, not per card. The buffer is pinned when the target
    is a CUDA device and copied there in one asynchronous transfer per
    leaf. Peak host memory is the buffer plus one chunk (returned in
    :class:`StreamStats`).
    """
    import torch.distributed as dist
    from repro_torch.core.dist import resolve_state_shards
    S = resolve_state_shards(state_shards)
    if pad_edges % S:
        raise ValueError(f"pad_edges={pad_edges} must be divisible by the "
                         f"{S} resolved state shard(s)")
    check_edge_addressing(pad_edges, where="make_instance_streamed")
    dev = resolve_device(device)
    pin = dev.type == "cuda"
    rank = dist.get_rank() if S > 1 else 0
    E_loc = pad_edges // S if rank < S else 0
    lo_e = rank * E_loc
    hi_e = lo_e + E_loc
    bufs = [torch.zeros(E_loc, dtype=dt, pin_memory=pin)
            for dt in (torch.int32, torch.int32, torch.float32, torch.bool)]
    buf_u, buf_v, buf_c, buf_ev = (b.numpy() for b in bufs)
    n_edges = 0
    n_chunks = 0
    peak = 0
    for cu, cv, cc in chunks:
        cu = np.asarray(cu, dtype=np.int32)
        cv = np.asarray(cv, dtype=np.int32)
        cc = np.asarray(cc, dtype=np.float32)
        if not (cu.shape == cv.shape == cc.shape and cu.ndim == 1):
            raise ValueError(
                f"chunk {n_chunks}: u/v/cost must be 1-D arrays of equal "
                f"length; got shapes {cu.shape}, {cv.shape}, {cc.shape}")
        first, last = n_edges, n_edges + len(cu)
        if last > pad_edges:
            raise ValueError(
                f"streamed edges exceed pad_edges={pad_edges}; raise the "
                f"pad (round_up_edges helps pick one)")
        s0, s1 = max(first, lo_e), min(last, hi_e)
        if s0 < s1:                         # the part of my range
            ku, kv, kc = (x[s0 - first:s1 - first] for x in (cu, cv, cc))
            if ku.min() < 0 or kv.min() < 0 \
                    or max(ku.max(), kv.max()) >= num_nodes:
                raise ValueError(f"chunk {n_chunks}: node ids must lie in "
                                 f"[0, {num_nodes})")
            if np.any((ku == kv) & (kc != 0.0)):
                raise ValueError(f"chunk {n_chunks}: self-loops must have "
                                 f"zero cost (see make_instance)")
            sl = slice(s0 - lo_e, s1 - lo_e)
            np.minimum(ku, kv, out=buf_u[sl])
            np.maximum(ku, kv, out=buf_v[sl])
            buf_c[sl] = kc
            buf_ev[sl] = True
        n_chunks += 1
        peak = max(peak, E_loc + len(cu))
        n_edges = last
    u, v, c, ev = (b.to(dev, non_blocking=pin) for b in bufs)
    Np = pad_nodes if pad_nodes is not None else num_nodes
    nv = torch.zeros(Np, dtype=torch.bool, device=dev)
    nv[:num_nodes] = True
    kind = MulticutInstance if S == 1 else EdgeRange
    return kind(u=u, v=v, cost=c, edge_valid=ev, node_valid=nv), \
        StreamStats(n_chunks=n_chunks, n_edges=n_edges,
                    peak_host_elems=peak)


def round_up_edges(num_edges: int, state_shards: int = 1,
                   blocks: int = 16) -> int:
    """Smallest pad_edges >= num_edges divisible by ``blocks`` (the
    reference's S-invariant blocked-reduction ranges) and by
    ``state_shards``: the pad a sharded solve can take."""
    q = math.lcm(max(1, int(blocks)), max(1, int(state_shards)))
    return ((max(1, num_edges) + q - 1) // q) * q


def to_networkx(inst: MulticutInstance):
    """The instance's valid nodes and edges as a ``networkx.Graph`` with
    the costs as ``weight`` (networkx is imported here, on use)."""
    import networkx as nx
    g = nx.Graph()
    g.add_nodes_from(range(int(inst.node_valid.sum())))
    u, v, c = to_host_edges(inst)
    for a, b, w_ in zip(u.tolist(), v.tolist(), c.tolist()):
        g.add_edge(a, b, weight=w_)
    return g


def attractive_degree_p95(inst: MulticutInstance, floor: int = ROW_CAP_FLOOR,
                          cap: int = 128) -> int:
    """Host-side p95 of the per-node attractive (cost > 0) degree over
    valid nodes, clamped to ``[floor, cap]`` — the one-shot
    ``sparse_row_cap_short`` tuning of ``api.solve(tune_sparse_caps=True)``.
    Any value gives bit-identical results; this picks the wall-clock
    sweet spot."""
    u = inst.u.cpu().numpy()
    v = inst.v.cpu().numpy()
    att = inst.edge_valid.cpu().numpy() & (inst.cost.cpu().numpy() > 0)
    deg = (np.bincount(u[att], minlength=inst.num_nodes)
           + np.bincount(v[att], minlength=inst.num_nodes))
    deg = deg[inst.node_valid.cpu().numpy()]
    p95 = float(np.percentile(deg, 95)) if deg.size else 0.0
    return int(np.clip(math.ceil(p95), floor, cap))


def lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort`` for torch: the permutation sorting by ``keys[-1]``
    first, ties broken by ``keys[-2]`` and so on. Torch has no lexsort and
    a packed int64 key overflows at paper scale (N·N·E), so this chains
    stable sorts, least significant key first."""
    order = None
    for k in keys:
        kk = k if order is None else k[order]
        perm = torch.sort(kk, stable=True).indices
        order = perm if order is None else order[perm]
    return order


# ---------------------------------------------------------------------------
# Sparse CSR graph view (the paper's representation; memory O(N + E))
# ---------------------------------------------------------------------------

class CsrGraph(NamedTuple):
    """Symmetric padded CSR adjacency over a masked edge subset.

    ``col``/``edge_id`` hold 2E slots. Row i's entries live at
    ``col[row_ptr[i]:row_ptr[i+1]]``, sorted ascending by neighbour id
    (ties by edge id). Dead slots are compacted to the tail and hold the
    sentinel ``N`` in ``col`` and ``-1`` in ``edge_id``.
    """
    row_ptr: torch.Tensor   # (N+1,) CSR offsets
    col: torch.Tensor       # (2E,) int32 neighbour node, N = dead sentinel
    edge_id: torch.Tensor   # (2E,) int32 edge index, -1 dead

    @property
    def num_nodes(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]


def build_csr(u, v, mask, num_nodes: int) -> CsrGraph:
    """COO→CSR: sort the 2E directed copies by (src, dst, eid); masked-out
    edges get sentinel endpoints that sort past every live row, and
    ``row_ptr`` falls out of one searchsorted over the sorted src column."""
    E = u.shape[0]
    check_edge_addressing(E, where="build_csr")
    dev = u.device
    src = torch.cat([u, v]).to(torch.int32)
    dst = torch.cat([v, u]).to(torch.int32)
    eid = torch.arange(E, dtype=index_dtype(E), device=dev).repeat(2)
    m = torch.cat([mask, mask])
    sent = torch.full_like(src, num_nodes)
    src = torch.where(m, src, sent)
    dst = torch.where(m, dst, sent)
    # reference: jnp.lexsort((eid, dst, src)) — chained stable sorts
    order = lexsort((eid, dst, src))
    src_s = src[order]
    row_ptr = torch.searchsorted(
        src_s, torch.arange(num_nodes + 1, dtype=torch.int32, device=dev),
        side="left").to(offset_dtype(E))
    eid_s = torch.where(m[order], eid[order], torch.full_like(eid, -1))
    return CsrGraph(row_ptr=row_ptr, col=dst[order],
                    edge_id=eid_s.to(torch.int32))


def csr_from_instance(inst: MulticutInstance,
                      attractive_only: bool = False) -> CsrGraph:
    """CSR over the valid edges; ``attractive_only`` restricts to c > 0."""
    mask = inst.edge_valid & (inst.cost > 0) if attractive_only \
        else inst.edge_valid
    return build_csr(inst.u, inst.v, mask, inst.num_nodes)


def csr_row_window(csr: CsrGraph, nodes: torch.Tensor, cap: int):
    """First ``cap`` entries of each node's CSR row, for a batch of nodes
    of any shape — the reference's per-node window under ``vmap`` as one
    batched gather.

    Returns (cols, eids, valid) of shape ``nodes.shape + (cap,)``, padded
    with the N sentinel / -1 past the row's degree. ``nodes`` may hold the
    sentinel N (an empty fan slot): JAX clamps the out-of-range
    ``row_ptr[N + 1]`` read, torch would fault, so the port clamps
    explicitly and an N row has degree 0 in both.
    """
    N = csr.num_nodes
    nnz = csr.col.shape[0]
    nodes = nodes.long()
    start = csr.row_ptr[nodes.clamp(0, N)].long()
    deg = csr.row_ptr[(nodes + 1).clamp(0, N)].long() - start
    pos = torch.arange(cap, dtype=torch.int64, device=nodes.device)
    idx = (start.unsqueeze(-1) + pos).clamp(0, max(nnz - 1, 0))
    ok = pos < deg.unsqueeze(-1)
    cols = torch.where(ok, csr.col[idx], torch.full_like(csr.col[idx], N))
    eids = torch.where(ok, csr.edge_id[idx],
                       torch.full_like(csr.edge_id[idx], -1))
    return cols, eids, ok


def _scatter_into(size: int, fill, dest: torch.Tensor, src: torch.Tensor):
    """``jnp.full(size, fill).at[dest].set(src, mode="drop")`` for
    ``dest`` in ``[0, size]``: position ``size`` is the drop slot."""
    out = torch.full((size + 1,), fill, dtype=src.dtype, device=src.device)
    out.scatter_(0, dest.long(), src)
    return out[:size]


def csr_filter(csr: CsrGraph, keep_edge: torch.Tensor) -> CsrGraph:
    """Sort-free row filter: the CSR restricted to edges with
    ``keep_edge[edge_id]`` True — one prefix sum + scatter, since dropping
    entries preserves the global (row, neighbour, edge id) order."""
    nnz = csr.col.shape[0]
    N = csr.num_nodes
    keep = (csr.edge_id >= 0) & keep_edge[csr.edge_id.clamp(min=0)]
    kept_before = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=keep.device),
        torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)])
    row_ptr = kept_before[csr.row_ptr.long()].to(torch.int32)
    dest = torch.where(keep, kept_before[1:] - 1,
                       torch.full_like(kept_before[1:], nnz))
    col = _scatter_into(nnz, N, dest, csr.col)
    eid = _scatter_into(nnz, -1, dest, csr.edge_id)
    return CsrGraph(row_ptr=row_ptr, col=col, edge_id=eid)


def csr_lookup_edge(csr: CsrGraph, a, b) -> torch.Tensor:
    """Edge id of each pair (a, b) or -1 — bisect-right over row a's sorted
    slice, batched over any shape. Fixed ceil(log2(2E))+1 iterations, like
    the reference's ``fori_loop``, so it returns exactly -1 or the largest
    edge id of duplicate parallel edges."""
    nnz = csr.col.shape[0]
    a = a.long().clamp(0, csr.num_nodes - 1)
    b = b.to(csr.col.dtype)
    lo0 = csr.row_ptr[a].long()
    lo, hi = lo0, csr.row_ptr[a + 1].long()
    iters = max(1, int(np.ceil(np.log2(max(2, nnz)))) + 1)
    for _ in range(iters):
        mid = ((lo + hi) // 2).clamp(0, nnz - 1)
        active = lo < hi
        go_right = active & (csr.col[mid] <= b)
        lo2 = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active, torch.where(go_right, hi, mid), hi)
        lo = lo2
    p = (lo - 1).clamp(0, nnz - 1)
    found = (lo > lo0) & (csr.col[p] == b)
    return torch.where(found, csr.edge_id[p],
                       torch.full_like(csr.edge_id[p], -1))


def _lex_count_less(rows, cols, eids, live, r, c, e) -> torch.Tensor:
    """Count of live CSR entries whose (row, col, edge_id) key sorts
    strictly before each (r, c, e) — a lexicographic bisect over the
    globally sorted entry arrays, batched over the queries, with the
    reference's fixed ceil(log2(nnz))+1 iterations."""
    nnz = cols.shape[0]
    iters = max(1, int(np.ceil(np.log2(max(2, nnz)))) + 1)
    lo = torch.zeros(r.shape, dtype=torch.int64, device=r.device)
    hi = live.to(torch.int64).expand(r.shape)
    for _ in range(iters):
        mid = ((lo + hi) // 2).clamp(0, nnz - 1)
        rm, cm, em = rows[mid], cols[mid], eids[mid]
        less = (rm < r) | ((rm == r) & ((cm < c) | ((cm == c) & (em < e))))
        active = lo < hi
        go_right = active & less
        lo2 = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active, torch.where(go_right, hi, mid), hi)
        lo = lo2
    return lo


def splice_csr(csr: CsrGraph, drop_edge: torch.Tensor, add_u: torch.Tensor,
               add_v: torch.Tensor, add_eid: torch.Tensor,
               add_ok: torch.Tensor) -> CsrGraph:
    """Merge an edge patch into a live CSR without a COO→CSR rebuild.

    ``drop_edge`` is an (E,) mask of edge ids whose entries leave the CSR;
    ``add_u``/``add_v``/``add_eid`` are (P,) new undirected edges (masked
    by ``add_ok``) inserted under their instance edge ids. Deletion is the
    prefix-sum compaction of :func:`csr_filter`; insertion sorts only the
    2P new directed entries and merges them into the sorted live region by
    a lexicographic bisect per new entry. Equal to ``build_csr`` of the
    patched instance, as in the reference. Every scatter writes distinct
    positions (the merge is a permutation) apart from the discarded drop
    slot, so the result does not depend on scatter order."""
    nnz = csr.col.shape[0]
    N = csr.num_nodes
    P = add_u.shape[0]
    dev = csr.col.device

    # 1. drop: compact out every entry of a dropped edge
    keep = (csr.edge_id >= 0) & ~drop_edge[csr.edge_id.clamp(min=0).long()]
    kept_before = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)])
    row_ptr_c = kept_before[csr.row_ptr.long()].to(torch.int32)
    dest = torch.where(keep, kept_before[1:] - 1,
                       torch.full_like(kept_before[1:], nnz))
    col_c = _scatter_into(nnz, N, dest, csr.col)
    eid_c = _scatter_into(nnz, -1, dest, csr.edge_id)
    live = row_ptr_c[N]
    ar = torch.arange(nnz, dtype=torch.int32, device=dev)
    # per-entry row id from row_ptr (the dead tail lands on row N)
    row_c = (torch.searchsorted(row_ptr_c, ar, right=True) - 1) \
        .to(torch.int32)

    # 2. the one bounded sort: 2P new directed entries by (src, dst, eid)
    src_n = torch.cat([add_u, add_v]).to(torch.int32)
    dst_n = torch.cat([add_v, add_u]).to(torch.int32)
    eid_n = torch.cat([add_eid, add_eid]).to(torch.int32)
    ok_n = torch.cat([add_ok, add_ok])
    sent = torch.full_like(src_n, N)
    src_n = torch.where(ok_n, src_n, sent)
    dst_n = torch.where(ok_n, dst_n, sent)
    order = lexsort((eid_n, dst_n, src_n))
    src_s, ok_s = src_n[order], ok_n[order]
    dst_s = torch.where(ok_s, dst_n[order], sent)
    eid_s = torch.where(ok_s, eid_n[order], torch.full_like(eid_n, -1))

    # 3. merge: each new entry bisects the live region (keys never collide:
    # an inserted edge id's old entries were dropped in step 1); old
    # entries shift by the number of new entries inserted at or before them
    ins = _lex_count_less(row_c, col_c, eid_c, live, src_s, dst_s, eid_s)
    new_pos = ins + torch.arange(2 * P, dtype=torch.int64, device=dev)
    shift = torch.searchsorted(ins, ar.to(torch.int64), right=True)
    old_pos = ar.to(torch.int64) + shift

    def place(fill, old, new):
        out = torch.full((nnz + 1,), fill, dtype=torch.int32, device=dev)
        out.scatter_(0, old_pos.clamp(max=nnz), old)
        out.scatter_(0, new_pos.clamp(max=nnz), new)
        return out[:nnz]

    row_ptr2 = row_ptr_c + torch.searchsorted(
        src_s, torch.arange(N + 1, dtype=torch.int32, device=dev),
        side="left").to(torch.int32)
    return CsrGraph(row_ptr=row_ptr2, col=place(N, col_c, dst_s),
                    edge_id=place(-1, eid_c, eid_s))


def resolve_graph_impl(graph_impl: str, num_nodes: int,
                       threshold: int = DEFAULT_SPARSE_THRESHOLD) -> str:
    """Static dense/sparse dispatch: "auto" flips to the CSR data path once
    the padded node count crosses ``threshold``."""
    if graph_impl == "auto":
        return "sparse" if num_nodes > threshold else "dense"
    if graph_impl not in ("dense", "sparse"):
        raise ValueError(f"unknown graph_impl {graph_impl!r}; expected one "
                         f"of {GRAPH_IMPLS}")
    return graph_impl


# ---------------------------------------------------------------------------
# Instance generators. The reference draws from np.random.default_rng, so
# these copies build identical instances from the same seed.
# ---------------------------------------------------------------------------

def random_instance(n: int, p: float, seed: int = 0, mu: float = 0.0,
                    sigma: float = 1.0, pad_edges: int | None = None,
                    pad_nodes: int | None = None,
                    device=None) -> MulticutInstance:
    """Erdos-Renyi graph with gaussian signed costs."""
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(n, k=1)
    keep = rng.random(len(iu)) < p
    u, v = iu[keep], ju[keep]
    c = rng.normal(mu, sigma, size=len(u)).astype(np.float32)
    return make_instance(u, v, c, n, pad_edges=pad_edges,
                         pad_nodes=pad_nodes, device=device)


def grid_instance(h: int, w: int, seed: int = 0, noise: float = 0.4,
                  n_segments: int = 6, long_range: bool = True,
                  pad_edges: int | None = None,
                  pad_nodes: int | None = None,
                  device=None) -> MulticutInstance:
    """Cityscapes-like grid instance: 4-connectivity + coarse long-range
    edges, costs derived from a planted segmentation + noise."""
    rng = np.random.default_rng(seed)
    cy = rng.uniform(0, h, n_segments); cx = rng.uniform(0, w, n_segments)
    yy, xx = np.mgrid[0:h, 0:w]
    d = (yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2
    seg = d.argmin(-1)

    def edge_cost(a_idx, b_idx):
        same = (seg.ravel()[a_idx] == seg.ravel()[b_idx]).astype(np.float32)
        base = np.where(same, 1.0, -1.0)
        return base + rng.normal(0, noise * 2,
                                 size=len(a_idx)).astype(np.float32)

    idx = np.arange(h * w).reshape(h, w)
    us, vs = [], []
    us.append(idx[:, :-1].ravel()); vs.append(idx[:, 1:].ravel())
    us.append(idx[:-1, :].ravel()); vs.append(idx[1:, :].ravel())
    if long_range:
        for (dy, dx) in [(0, 4), (4, 0), (3, 3)]:
            if h > dy and w > dx:
                us.append(idx[: h - dy, : w - dx].ravel())
                vs.append(idx[dy:, dx:].ravel())
    u = np.concatenate(us); v = np.concatenate(vs)
    c = edge_cost(u, v)
    return make_instance(u, v, c, h * w, pad_edges=pad_edges,
                         pad_nodes=pad_nodes, device=device)


def cluster_instance(n: int, k: int = 4, p_in: float = 0.6,
                     p_out: float = 0.1, seed: int = 0, noise: float = 0.5,
                     pad_edges: int | None = None,
                     pad_nodes: int | None = None,
                     device=None) -> MulticutInstance:
    """Planted-partition instance: k ground-truth clusters, dense attractive
    edges inside, sparse repulsive edges across, gaussian cost noise."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, k, size=n)
    iu, ju = np.triu_indices(n, k=1)
    same = assign[iu] == assign[ju]
    keep = rng.random(len(iu)) < np.where(same, p_in, p_out)
    u, v = iu[keep], ju[keep]
    base = np.where(same[keep], 1.0, -1.0).astype(np.float32)
    c = base + rng.normal(0, noise, size=len(u)).astype(np.float32)
    return make_instance(u, v, c, n, pad_edges=pad_edges,
                         pad_nodes=pad_nodes, device=device)
