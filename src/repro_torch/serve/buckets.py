"""Size bucketing + shape padding for the serving engine (port of
``repro.serve.buckets``).

Every registry entry counts one "compile" per input shape, so a stream of
arbitrary-size instances would add one per new (N, E) pair.
:class:`BucketPolicy` quantises instance shapes onto a geometric grid of
**buckets**, so the number of distinct shapes is logarithmic in the size
range served, and :func:`pad_instance` lifts any instance onto its bucket
shape with *neutral filler*:

* padded edge slots are zero-cost self-loops at node 0 with
  ``edge_valid=False`` — the slots ``make_instance`` already emits past the
  live prefix, which every solver path masks out;
* padded node slots are ``node_valid=False`` — they never join a
  contraction set, never appear in a CSR row, and keep their identity
  label.

The padded solve runs the same masked arithmetic over a longer zero tail.
Free edge slots are also *separation capacity* (cycle chords allocate into
them), so an instance arriving with no free slot can gain chords when
bucketed and its bound can tighten; results are therefore held against
the solve of the *padded* instance.

:func:`filler_instance` (an all-invalid instance) fills the tail of a
partial batch so each dispatch of a (bucket, route) has one of a few
static batch sizes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.graph import MulticutInstance, resolve_device


class Bucket(NamedTuple):
    """A padded (nodes, edges) shape class — the unit of compilation."""
    nodes: int
    edges: int


def _geom_ceil(x: int, floor: int, growth: float, cap: int | None,
               what: str) -> int:
    """Smallest rung of the geometric ladder floor·growth^k that is ≥ x
    (integer ladder: each rung is ceil(prev·growth), so it is exact and
    strictly increasing for growth > 1). Clamped to ``cap``; x past the
    cap is an admission error, not a silent truncation."""
    if x < 0:
        raise ValueError(f"negative {what} count {x}")
    if cap is not None and x > cap:
        raise ValueError(f"instance needs {x} {what} slots, over the "
                         f"policy cap {cap}")
    s = max(1, floor)
    while s < x:
        s = int(-(-s * growth // 1))      # ceil(s * growth)
    return s if cap is None else min(s, cap)


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Geometric (nodes, edges) bucketing. Frozen + hashable, so a policy
    can key caches alongside the route.

    ``growth`` trades compile count against padding waste: the ladder has
    O(log_growth(range)) rungs and the worst-case padded/true size ratio
    is ``growth`` per axis. Caps bound the largest admissible instance
    (an instance past a cap raises at admission — the serving layer's
    contract is that every admitted request fits a compiled shape).
    """
    node_floor: int = 64
    edge_floor: int = 256
    growth: float = 2.0
    node_cap: int | None = None
    edge_cap: int | None = None

    def __post_init__(self):
        if self.growth <= 1.0:
            raise ValueError(f"growth must exceed 1.0, got {self.growth}")
        if self.node_floor < 1 or self.edge_floor < 1:
            raise ValueError("bucket floors must be >= 1")

    def bucket_for(self, num_nodes: int, num_edges: int) -> Bucket:
        """The bucket an instance with these *padded* counts lands in."""
        return Bucket(
            nodes=_geom_ceil(num_nodes, self.node_floor, self.growth,
                             self.node_cap, "node"),
            edges=_geom_ceil(num_edges, self.edge_floor, self.growth,
                             self.edge_cap, "edge"))

    def bucket_of(self, inst: MulticutInstance) -> Bucket:
        return self.bucket_for(inst.num_nodes, inst.num_edges)


def _pad(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.cat([x, torch.zeros(d, dtype=x.dtype, device=x.device)])


def pad_instance(inst: MulticutInstance, bucket: Bucket) -> MulticutInstance:
    """Lift ``inst`` onto ``bucket``'s shape with neutral filler slots
    (zero-cost invalid self-loops / invalid nodes — see module docstring),
    on the instance's device; a no-op when it already has the bucket
    shape."""
    dn = bucket.nodes - inst.num_nodes
    de = bucket.edges - inst.num_edges
    if dn < 0 or de < 0:
        raise ValueError(f"instance shape ({inst.num_nodes} nodes, "
                         f"{inst.num_edges} edges) exceeds bucket {bucket}")
    if dn == 0 and de == 0:
        return inst
    return MulticutInstance(
        u=_pad(inst.u, de), v=_pad(inst.v, de), cost=_pad(inst.cost, de),
        edge_valid=_pad(inst.edge_valid, de),
        node_valid=_pad(inst.node_valid, dn))


def filler_instance(bucket: Bucket, device=None) -> MulticutInstance:
    """An all-invalid instance of the bucket shape on ``device`` (default
    ``cuda``): zero nodes, zero edges live. Solves cleanly in every mode
    (the round loop exits after one no-contraction round) and pads
    partial batches to the engine's batch sizes."""
    dev = resolve_device(device)
    E, N = bucket.edges, bucket.nodes
    return MulticutInstance(
        u=torch.zeros(E, dtype=torch.int32, device=dev),
        v=torch.zeros(E, dtype=torch.int32, device=dev),
        cost=torch.zeros(E, dtype=torch.float32, device=dev),
        edge_valid=torch.zeros(E, dtype=torch.bool, device=dev),
        node_valid=torch.zeros(N, dtype=torch.bool, device=dev))


def pad_batch(instances: list[MulticutInstance], bucket: Bucket,
              batch: int) -> MulticutInstance:
    """Pad each instance to ``bucket``, fill the tail with
    :func:`filler_instance` (on the first instance's device) up to
    ``batch`` slots, and stack — the (batch, bucket) shape every engine
    dispatch presents to its registry entry."""
    if not instances:
        raise ValueError("need at least one instance")
    if len(instances) > batch:
        raise ValueError(f"{len(instances)} instances exceed the batch "
                         f"cap {batch}")
    from repro_torch.api import stack_instances
    padded = [pad_instance(i, bucket) for i in instances]
    padded += [filler_instance(bucket, instances[0].device)] \
        * (batch - len(instances))
    return stack_instances(padded)


def strip_result(res, num_nodes: int):
    """Undo the node padding on a single-instance SolveResult: labels come
    back at the request's original padded length; scalars and per-round
    history are untouched (padding adds only exact-zero terms to them)."""
    return res._replace(labels=res.labels[:num_nodes])


def batch_ladder(batch_cap: int, shards: int = 1) -> tuple[int, ...]:
    """The geometric sub-batch ladder for partial flushes: ``batch_cap``
    plus every power of two below it, descending (restricted to multiples
    of ``shards`` so each rung still splits across the route's batch
    shards). A partial queue decomposed over these rungs dispatches with
    (near-)zero filler slots instead of padding straight to ``batch_cap``
    — the batched entry then never solves dead slots — at the cost of at
    most ``len(ladder)`` batch shapes per (bucket, route) instead of one
    (the same logarithmic trade the bucket ladder makes for instance
    shapes)."""
    if batch_cap < 1:
        raise ValueError(f"batch_cap must be >= 1, got {batch_cap}")
    if shards < 1 or batch_cap % shards:
        raise ValueError(f"batch_cap={batch_cap} must be a positive "
                         f"multiple of shards={shards}")
    rungs = [batch_cap]
    p = 1
    while p < batch_cap:
        if p % shards == 0 and p not in rungs:
            rungs.append(p)
        p <<= 1
    return tuple(sorted(rungs, reverse=True))


def decompose_batch(n: int, rungs: tuple[int, ...]) -> list[tuple[int, int]]:
    """Greedy decomposition of ``n`` queued requests over a descending
    rung ladder: a list of ``(take, size)`` dispatch chunks with ``take``
    real requests padded to ``size`` slots. Exact (zero filler) whenever
    the ladder contains 1 — true for every power-of-two-ladder from
    :func:`batch_ladder` with ``shards=1``; with coarser ladders only the
    final chunk pads (to the smallest rung)."""
    if n < 1:
        raise ValueError(f"need at least one queued request, got {n}")
    out = []
    for r in rungs:
        while n >= r:
            out.append((r, r))
            n -= r
    if n:
        out.append((n, rungs[-1]))
    return out
