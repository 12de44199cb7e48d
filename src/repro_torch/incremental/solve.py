"""Delta re-solve: apply a patch, then solve — exactly or warm.

Port of ``repro.incremental.solve``:

* :func:`solve_cold_device` — solve an instance from scratch and open a
  :class:`DeltaState` around the result (builds the one CSR every later
  tick splices).
* :func:`solve_delta_device` — apply a :class:`DeltaPatch` to the carried
  state (CSR maintained by :func:`repro_torch.core.graph.splice_csr`) and
  re-solve.

**Exact mode** hands the patched instance and its spliced CSR to
:func:`repro_torch.core.solver.solve_device`. The spliced CSR equals a
fresh ``build_csr`` of the patched instance and the solve is
deterministic, so the result equals a cold solve of the patched problem
bit for bit.

**Warm mode** lifts the previous solution: intra-cluster edges outside the
patch frontier (no endpoint within ``SolverConfig.delta_halo`` hops of a
patched edge), and the frontier ones still attractive under the patched
costs, are pre-contracted in one ``contract_csr`` sweep (its float sums in
a fixed order), and round 0's separation is restricted to the frontier.
The condensed problem's dual bound does not transfer to the original, so
a warm tick reports the **carried** bound: the last exact/cold tick's
bound plus each patch's ``lb_slack`` — valid for the patched problem, if
loose. The objective is recomputed on the full patched instance, so it is
always the true objective of the returned labels.
"""
from __future__ import annotations

import torch

from repro_torch.core.contraction import contract_csr
from repro_torch.core.graph import MulticutInstance
from repro_torch.core.solver import SolveResult, SolverConfig, solve_device
from repro_torch.incremental.patch import DeltaPatch, PatchInfo, _set, \
    apply_patch
from repro_torch.incremental.state import DeltaState, init_delta_state

__all__ = ["patch_frontier", "solve_cold_device", "solve_delta_device"]


def _carriable_bound(lb: torch.Tensor) -> torch.Tensor:
    """A solve's reported bound, as the carried DeltaState slot holds it:
    −inf survives (it stays a valid bound under any patch slack), NaN
    would poison every later warm tick and becomes −inf."""
    lb = lb.to(torch.float32)
    return torch.where(torch.isnan(lb), torch.full_like(lb, float("-inf")),
                       lb)


def solve_cold_device(inst: MulticutInstance, mode: str = "pd",
                      cfg: SolverConfig = SolverConfig(), mp=None,
                      intersect=None) -> tuple[SolveResult, DeltaState]:
    """Cold solve and opened state: the first tick of a delta session. The
    CSR is built once here, feeds the solve (sparse path), and is carried
    in the returned state for the next tick's splice."""
    state = init_delta_state(inst)
    res = solve_device(inst, mode, cfg, mp=mp, intersect=intersect,
                       csr=state.csr)
    return res, state._replace(
        labels=res.labels.to(torch.int32),
        has_solution=torch.tensor(mode != "d", device=inst.device),
        lower_bound=_carriable_bound(res.lower_bound))


def _mark(n: int, idx: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """(n,) bool with True at ``idx`` where ``on``: the reference's boolean
    ``.at[idx].max(on)``, order-free (every write is True)."""
    dest = torch.where(on & (idx >= 0) & (idx < n), idx.long(),
                       torch.full_like(idx, n, dtype=torch.long))
    return _set(torch.zeros(n, dtype=torch.bool, device=idx.device), dest,
                True)


def patch_frontier(inst: MulticutInstance, patch: DeltaPatch,
                   halo: int) -> torch.Tensor:
    """(N,) bool — patched endpoints plus a ``halo``-hop neighbourhood over
    the valid edges of the *patched* instance: the nodes whose clustering
    the patch can plausibly change on the first warm round."""
    N = inst.num_nodes
    ok = patch.valid & (patch.u != patch.v)
    fr = _mark(N, patch.u, ok) | _mark(N, patch.v, ok)
    u, v = inst.u.long(), inst.v.long()
    for _ in range(max(0, int(halo))):
        hit = inst.edge_valid & (fr[u] | fr[v])
        fr = fr | _mark(N, u, hit) | _mark(N, v, hit)
    return fr & inst.node_valid


def _warm_seed(inst2: MulticutInstance, state: DeltaState,
               patch: DeltaPatch, halo: int):
    """Pre-contract the previous solution away from the patch frontier.

    Returns ``(inst_c, csr_c, lift, fr_c)``: the condensed instance and its
    CSR (from ``contract_csr``'s own sort), the (N,) original-node →
    condensed-node map the final labels compose through, and the condensed
    frontier mask for round-0 separation. Before the first solve
    (``has_solution`` False) the stable set is empty and this is an
    identity contraction."""
    N = inst2.num_nodes
    fr = patch_frontier(inst2, patch, halo)
    labels = state.labels.clamp(0, N - 1).long()
    u, v = inst2.u.long(), inst2.v.long()
    # stable = intra-cluster edges entirely outside the frontier (cluster
    # cores carry over wholesale) or still attractive under the patched
    # costs (at the frontier the old assignment survives where its
    # support does; a node whose attachment went non-positive falls out
    # as a singleton, free to re-join in the warm rounds)
    stable = inst2.edge_valid & state.has_solution \
        & (labels[u] == labels[v]) \
        & ((inst2.cost > 0) | (~fr[u] & ~fr[v]))
    res0, csr_c = contract_csr(inst2, stable)
    lift = res0.mapping.to(torch.int32)
    fr_c = _mark(N, lift, fr & inst2.node_valid)
    return res0.instance, csr_c, lift, fr_c


def solve_delta_device(state: DeltaState, patch: DeltaPatch,
                       mode: str = "pd",
                       cfg: SolverConfig = SolverConfig(), mp=None,
                       intersect=None, warm: bool = False,
                       ) -> tuple[SolveResult, DeltaState, PatchInfo]:
    """One update tick: splice the patch in, re-solve, carry the state.

    Exact mode equals a cold solve of the patched instance bit for bit;
    warm mode reports the carried bound (previous bound + patch slack) and
    re-solves only the patched neighbourhood. Mode "d" has no primal
    solution to carry, so warm "d" raises (exact "d" re-runs the dual)."""
    if warm and mode == "d":
        raise ValueError("warm delta re-solve needs a primal solution to "
                         "lift; mode 'd' produces none — use exact mode")
    inst2, csr2, info = apply_patch(state.instance, state.csr, patch)
    if not warm:
        res = solve_device(inst2, mode, cfg, mp=mp, intersect=intersect,
                           csr=csr2)
        final = res.labels.to(torch.int32)
        carried = _carriable_bound(res.lower_bound)
    else:
        inst_c, csr_c, lift, fr_c = _warm_seed(inst2, state, patch,
                                               cfg.delta_halo)
        res_c = solve_device(inst_c, mode, cfg, mp=mp, intersect=intersect,
                             csr=csr_c, sep_node_mask=fr_c)
        final = res_c.labels.to(torch.int32)[lift.long()]
        carried = (state.lower_bound + info.lb_slack).to(torch.float32)
        res = res_c._replace(labels=final, objective=inst2.objective(final),
                             lower_bound=carried)
    state2 = DeltaState(instance=inst2, csr=csr2, labels=final,
                        has_solution=torch.tensor(mode != "d",
                                                  device=inst2.device),
                        lower_bound=carried)
    return res, state2, info
