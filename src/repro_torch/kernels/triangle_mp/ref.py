"""Plain PyTorch versions of the triangle message-passing kernels — the
oracles the CUDA kernels are held to, bit for bit.

:func:`mp_sweep_ref` is the sweep alone (Alg. 2, lines 8-13).
:func:`mp_phase_ref` is one whole message-passing phase (Alg. 2, ``iters``
passes) on compact triangle-edge ids, the layout of the reference's
``run_message_passing_sharded``: the ≤ 3T distinct edge ids of the valid
triangles are relabelled to [0, U), their costs are gathered once, and
every pass sums each compact segment's entries in flat (triangle-major,
slot-minor) order from +0.0 — the entries and the order the per-edge
``core.message_passing.run_message_passing`` sums, so the two give the
same bits.

Each step is separate torch ops (a product, then a difference; a sum,
then a quotient), so no multiply-add is fused; the kernels are compiled
without FMA contraction and round each operation on its own to give the
same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sparse.segment_ops import sequential_sums


def _mm(a, b, c):
    """Min-marginal of the first edge given triangle costs (a, b, c)."""
    s = b + c
    return a + torch.minimum(torch.minimum(b, c), s) \
        - torch.minimum(s, torch.zeros_like(s))


def mp_sweep_ref(t_cost: torch.Tensor) -> torch.Tensor:
    """t_cost: (..., 3) triangle subproblem costs. Returns swept costs after
    the fixed sequence e1:1/3, e2:1/2, e3:1, e1:1/2, e2:1, e1:1 — each
    min-marginal computed on the current costs (λ += γm ⇔ cost −= γm)."""
    a, b, c = t_cost[..., 0], t_cost[..., 1], t_cost[..., 2]
    a = a - (1.0 / 3.0) * _mm(a, b, c)
    b = b - (1.0 / 2.0) * _mm(b, a, c)
    c = c - 1.0 * _mm(c, a, b)
    a = a - (1.0 / 2.0) * _mm(a, b, c)
    b = b - 1.0 * _mm(b, a, c)
    a = a - 1.0 * _mm(a, b, c)
    return torch.stack([a, b, c], dim=-1)


class MPPlan(NamedTuple):
    """The compact layout of one MP phase, built by :func:`mp_plan` with
    torch ops of size ≤ 3T and no host sync. A compact segment is one
    distinct edge id of the valid triangles: a run of equal keys in the
    stable sort of the valid slots' edge ids (the sort the kernel's
    wrapper makes; the kernel finds each slot's run itself). Segment ids
    past the last one (U ≤ 3T of them, a count that stays on the device)
    have length 0, and so does the segment of the invalid rows' slots."""
    comp: torch.Tensor      # (T, 3) int32: each slot's compact segment
    entries: torch.Tensor   # (3T,) int32: flat slots (3·row + slot) by
    #                         segment, flat order inside a segment
    start: torch.Tensor     # (3T,) int32: a segment's first entry
    length: torch.Tensor    # (3T,) int32: its entries = the edge's degree
    edge: torch.Tensor      # (3T,) int64: its edge id (E past the last)
    cost_at: torch.Tensor   # (3T,) float32: cost[edge] (0 past the last)


def mp_plan(cost: torch.Tensor, tri: torch.Tensor,
            tri_valid: torch.Tensor) -> MPPlan:
    """The compact plan of the triangles ``tri`` (T, 3) over ``cost`` (E,).
    Invalid rows' slots sort after every edge (key E) and are left out."""
    T, E = tri.shape[0], cost.shape[0]
    n = 3 * T
    dev = tri.device
    valid_slot = tri_valid[:, None].expand(T, 3).reshape(-1)
    key = torch.where(valid_slot, tri.reshape(-1).long(),
                      torch.full((n,), E, dtype=torch.int64, device=dev))
    sorted_key, entries = torch.sort(key, stable=True)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    seg = torch.cumsum(first, 0) - 1                # segment of each entry
    comp = torch.empty(n, dtype=torch.int64, device=dev)
    comp[entries] = seg
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    start = torch.searchsorted(seg, ids)
    length = torch.searchsorted(seg, ids, right=True) - start
    edge = sorted_key[start.clamp(max=n - 1)]
    real = (length > 0) & (edge < E)
    length = torch.where(real, length, torch.zeros_like(length))
    edge = torch.where(real, edge, torch.full_like(edge, E))
    cost_at = torch.where(real, cost[edge.clamp(max=E - 1)],
                          torch.zeros((), dtype=cost.dtype, device=dev))
    i32 = torch.int32
    return MPPlan(comp=comp.to(i32).view(T, 3), entries=entries.to(i32),
                  start=start.to(i32), length=length.to(i32), edge=edge,
                  cost_at=cost_at)


def lower_bound_terms(c_rep, edge_valid, t_cost, tri_valid) -> torch.Tensor:
    """LB(λ) of (5): Σ_e min(0, c^λ_e) + Σ_t min_{y∈M_T} ⟨c_t^λ, y⟩, from
    the reparametrised costs and the triangle costs."""
    zero = torch.zeros_like(c_rep)
    lb_e = torch.where(edge_valid, torch.minimum(c_rep, zero), zero).sum()
    a, b, c = t_cost[:, 0], t_cost[:, 1], t_cost[:, 2]
    states = torch.stack([torch.zeros_like(a), a + b, a + c, b + c,
                          a + b + c], dim=-1)
    mins = states.min(dim=-1).values
    lb_t = torch.where(tri_valid, mins, torch.zeros_like(mins)).sum()
    return lb_e + lb_t


def _slot_costs(plan: MPPlan, t_cost: torch.Tensor, max_len: int):
    """Each slot's reparametrised cost c^λ = c_e − Σ t_cost over its
    segment, the entries added one by one from +0.0 in flat order."""
    data = -t_cost.reshape(-1)[plan.entries.long()]
    sums = sequential_sums(data, plan.start.long(), plan.length, max_len)
    comp = plan.comp.long()
    return plan.cost_at[comp] + sums[comp]


def mp_phase_ref(cost: torch.Tensor, edge_valid: torch.Tensor,
                 tri: torch.Tensor, tri_valid: torch.Tensor, iters: int):
    """``iters`` passes of Alg. 2 from zero triangle costs. Returns
    (t_cost (T, 3), c_rep (E,), lb ()). Each pass: each valid slot's
    reparametrised cost, its share c^λ / deg added to the triangle, then
    the sweep; invalid rows stay 0. The landing: c_rep over all edges is
    ``cost + 0.0`` (a −0.0 cost becomes +0.0, as adding an empty sum
    does), with the touched edges overwritten."""
    T, E = tri.shape[0], cost.shape[0]
    t_cost = torch.zeros((T, 3), dtype=torch.float32, device=cost.device)
    c_rep = cost + 0.0
    if T == 0 or E == 0:
        return t_cost, c_rep, lower_bound_terms(c_rep, edge_valid, t_cost,
                                                tri_valid)
    plan = mp_plan(cost, tri, tri_valid)
    # the longest segment bounds the plain version's loop; the kernel reads
    # each segment's length itself and needs no such number
    max_len = int(plan.length.max())
    deg = plan.length[plan.comp.long()]
    valid = tri_valid[:, None]
    for _ in range(iters):
        c_at = _slot_costs(plan, t_cost, max_len)
        share = torch.where(deg > 0, c_at / deg.clamp(min=1),
                            torch.zeros_like(c_at))
        t_cost = torch.where(valid, t_cost + share, t_cost)
        t_cost = torch.where(valid, mp_sweep_ref(t_cost), t_cost)
    c_at = _slot_costs(plan, t_cost, max_len)
    land = torch.where(valid, tri.long(), torch.full_like(tri, E).long())
    c_rep = torch.cat([c_rep, c_rep.new_zeros(1)]).index_put_(
        (land.reshape(-1),), c_at.reshape(-1))[:E]
    return t_cost, c_rep, lower_bound_terms(c_rep, edge_valid, t_cost,
                                            tri_valid)
