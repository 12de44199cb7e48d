"""Dual: parallel message passing / dual block coordinate ascent (Alg. 2).

Port of the replicated half of ``repro.core.message_passing``. Lagrange
decomposition (5): edge subproblems (min(0, c^λ_e)) + triangle subproblems
over M_T = {(0,0,0),(1,1,0),(1,0,1),(0,1,1),(1,1,1)}; every triangle is
updated independently, so one pass runs over all triangles at once.
This is the reference's per-edge layout; the solver's default route runs
the whole phase as one kernel on compact triangle-edge ids instead
(``kernels.triangle_mp.ops.mp_phase``), with the same bits.

Triangle costs are stored directly (t_cost = −λ); the reparametrised edge
cost is c^λ_e = c_e − Σ_t t_cost[t, slot(e)].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.cycles import Triangles
from repro_torch.kernels.triangle_mp.ref import lower_bound_terms
from repro_torch.sparse.segment_ops import SegmentPlan, segment_plan, \
    segment_sum


class MPState(NamedTuple):
    t_cost: torch.Tensor     # (T, 3) triangle subproblem costs c_t^λ = -λ_t
    tri: torch.Tensor        # (T, 3) edge ids
    tri_valid: torch.Tensor  # (T,)


def init_mp(triangles: Triangles) -> MPState:
    T = triangles.edges.shape[0]
    return MPState(t_cost=torch.zeros((T, 3), dtype=torch.float32,
                                      device=triangles.edges.device),
                   tri=triangles.edges, tri_valid=triangles.valid)


def edge_degree(state: MPState, num_edges: int) -> torch.Tensor:
    """Number of triangles containing each edge (an exact integer count)."""
    ones = state.tri_valid[:, None].expand(state.tri.shape).to(torch.int64)
    return segment_sum(ones.reshape(-1), state.tri.reshape(-1),
                       num_edges).to(torch.int32)


def triangle_plan(state: MPState, num_edges: int) -> SegmentPlan:
    """The fixed-order sum plan of the valid triangles' edge slots. Invalid
    rows (zeroed, so all on edge 0) contribute exactly 0.0 and adding 0.0
    changes no sum, so they are left out rather than lengthening edge 0's
    sum."""
    ids = torch.where(state.tri_valid[:, None], state.tri,
                      torch.full_like(state.tri, -1))
    return segment_plan(ids.reshape(-1), num_edges)


def reparametrized_costs(cost, state: MPState,
                         plan: SegmentPlan | None = None) -> torch.Tensor:
    """c^λ_e = c_e + Σ_{t ∋ e} λ_{t,e} = c_e − Σ t_cost.

    The sum is a float segment sum in a fixed order (each edge's entries in
    triangle order — see :mod:`repro_torch.sparse.segment_ops`), never an
    atomic scatter-add. ``plan`` reuses the sort of the triangle edge ids
    across iterations (they do not change during one MP phase)."""
    E = cost.shape[0]
    if plan is None:
        plan = triangle_plan(state, E)
    contrib = torch.where(state.tri_valid[:, None], -state.t_cost,
                          torch.zeros_like(state.t_cost))
    return cost + plan.sum(contrib)


def _mm_single(t_cost, slot):
    """Min-marginal of one edge slot (0/1/2) of each triangle."""
    a = t_cost[..., slot]
    b = t_cost[..., (slot + 1) % 3]
    c = t_cost[..., (slot + 2) % 3]
    s = b + c
    return a + torch.minimum(torch.minimum(b, c), s) \
        - torch.minimum(s, torch.zeros_like(s))


def edges_to_triangles(state: MPState, cost: torch.Tensor,
                       plan: SegmentPlan | None = None,
                       deg: torch.Tensor | None = None):
    """Lines 1–6: each edge pushes its reparametrized cost uniformly onto the
    triangles containing it. After the update c^λ_e = 0 for every covered
    edge."""
    E = cost.shape[0]
    c_rep = reparametrized_costs(cost, state, plan)
    if deg is None:
        deg = edge_degree(state, E)
    share = torch.where(deg > 0, c_rep / deg.clamp(min=1),
                        torch.zeros_like(c_rep))
    upd = share[state.tri.long()] * state.tri_valid[:, None]
    return state._replace(t_cost=state.t_cost + upd)


def triangles_to_edges(state: MPState, sweep=None):
    """Lines 7–14: per-triangle sequential sweep distributing min-marginals
    back to the edges. ``sweep`` swaps in the kernel ((T,3) → (T,3));
    invalid rows keep their costs (masked here, outside the kernel, as in
    the reference)."""
    if sweep is None:
        sweep = mp_sweep_reference
    new_cost = sweep(state.t_cost)
    new_cost = torch.where(state.tri_valid[:, None], new_cost, state.t_cost)
    return state._replace(t_cost=new_cost)


def mp_sweep_reference(t_cost: torch.Tensor) -> torch.Tensor:
    """Plain oracle of the triangle sweep (Alg. 2 lines 8–13):
    e1 += 1/3·m1; e2 += 1/2·m2; e3 += 1·m3; e1 += 1/2·m1; e2 += 1·m2;
    e1 += 1·m1 — each on the *current* costs (λ += γm ⇔ cost −= γm)."""
    tc = t_cost
    for slot, gamma in ((0, 1.0 / 3.0), (1, 1.0 / 2.0), (2, 1.0),
                        (0, 1.0 / 2.0), (1, 1.0), (0, 1.0)):
        m = _mm_single(tc, slot)
        col = tc[..., slot] + (-gamma) * m
        tc = torch.cat([tc[..., :slot], col[..., None], tc[..., slot + 1:]],
                       dim=-1)
    return tc


def lower_bound(cost, edge_valid, state: MPState,
                plan: SegmentPlan | None = None) -> torch.Tensor:
    """LB(λ) of (5): Σ_e min(0, c^λ_e) + Σ_t min_{y∈M_T} ⟨c_t^λ, y⟩."""
    c_rep = reparametrized_costs(cost, state, plan)
    return lower_bound_terms(c_rep, edge_valid, state.t_cost,
                             state.tri_valid)


def run_message_passing(cost, edge_valid, state: MPState, iters: int,
                        sweep=None):
    """k iterations of Alg. 2. Returns (state, reparametrized costs, LB).
    The triangle edge ids are fixed for the phase, so their sort order and
    edge degrees are computed once."""
    E = cost.shape[0]
    plan = triangle_plan(state, E)
    deg = edge_degree(state, E)
    for _ in range(iters):
        state = edges_to_triangles(state, cost, plan, deg)
        state = triangles_to_edges(state, sweep=sweep)
    c_rep = reparametrized_costs(cost, state, plan)
    lb = lower_bound(cost, edge_valid, state, plan)
    return state, c_rep, lb


def mp_phase_per_edge(cost, edge_valid, tri, tri_valid, iters: int):
    """:func:`run_message_passing` with the plain sweep, in the signature of
    the fused phase (``kernels.triangle_mp.ops.mp_phase``): (t_cost, c_rep,
    lb). The per-edge layout, kept as the solver's ``"reference"`` route so
    that a run on the card holds the fused kernel against it."""
    state = init_mp(Triangles(edges=tri, valid=tri_valid))
    state, c_rep, lb = run_message_passing(cost, edge_valid, state, iters)
    return state.t_cost, c_rep, lb
