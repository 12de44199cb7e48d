"""Primal-dual multicut solver (RAMA Alg. 3) and the paper's variants.

Port of ``repro.core.solver``:

  P   — purely primal: matching / spanning-forest contraction only.
  PD  — interleaved: cycle separation (5-cycles on the original graph,
        3-cycles on contracted graphs) → k message-passing iterations →
        reparametrise → contract. LB from the first (original-graph) round.
  PD+ — PD with 5-cycle separation in every round.
  D   — dual only: separation + message passing on the original graph.

Every mode runs on both separation data paths (``graph_impl``): on the
sparse path the CSR is built once per solve and maintained by contraction
(:class:`SolverState`), or, in mode D, by splicing each round's chords in;
the dense path rebuilds its (N, N) matrices each round.

The reference runs the outer loops as ``lax.while_loop``s with no host
sync. Torch runs eagerly, so P and PD read the round's contraction count
to exit early on zero — one host sync per round — and the connected
components and long-bucket separation pass add their own. D is a fixed
number of rounds and needs no exit sync. CUDA graphs come later.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.profiler import record_function

from repro_torch.core.contraction import choose_contraction_set, \
    contract, contract_csr
from repro_torch.core.cycles import separate
from repro_torch.core.graph import (
    DEFAULT_SPARSE_THRESHOLD, GRAPH_IMPLS, CsrGraph, MulticutInstance,
    csr_from_instance, resolve_graph_impl,
)
from repro_torch.core.message_passing import mp_phase_per_edge

MODES = ("p", "pd", "pd+", "d")
# "cuda" = the hand-written kernels (the default; on a CPU tensor each
# kernel wrapper runs its plain version); "reference" = the plain PyTorch
# versions everywhere, kept so a run on the card can compare the two
BACKENDS = ("reference", "cuda")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """RAMA solver hyper-parameters — the reference's fields and defaults,
    so one config means the same solve in both packages."""
    max_rounds: int = 16            # outer PD rounds
    mp_iters: int = 5               # k message-passing iterations per round
    max_neg: int = 256              # repulsive edges separated per round
    max_tri_per_edge: int = 4       # triangles per repulsive edge
    nbr_k: int = 4                  # neighbour fan for 4/5-cycle search
    first_round_cycles45: bool = True   # PD: length-5 on the original graph
    always_cycles45: bool = False       # PD+: length-5 every round
    matching_rounds: int = 3
    forest_rounds: int = 4
    switch_frac: float = 0.1
    contract_frac: float = 0.0      # GAEC-like conservatism (0 = paper)
    dual_rounds: int = 4            # D: separation+MP rounds
    graph_impl: str = "auto"        # separation data path: dense|sparse|auto
    sparse_row_cap: int = 128       # CSR row window
    sparse_row_cap_short: int = 16  # two-level degree buckets (0 disables)
    sparse_threshold: int = DEFAULT_SPARSE_THRESHOLD
    separation_chunk: int = 0       # sparse: repulsive edges per chunk
    separation_shards: int = 1      # sparse: devices for the chunk axis
    state_shards: int = 0           # >=1: edge-range-partitioned solve
    delta_halo: int = 2             # warm delta re-solve halo (hops)

    def cache_key(self) -> tuple:
        """The canonical key: the ordered tuple of field values."""
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))


class SolveResult(NamedTuple):
    """Solve output. History is stacked per-round arrays of length
    ``max_rounds``; slots past ``rounds`` keep their initial values
    (lb = -inf, counts = 0)."""
    labels: torch.Tensor        # (N,) final cluster id per original node
    objective: torch.Tensor     # () primal objective on the original
    lower_bound: torch.Tensor   # () dual LB
    rounds: torch.Tensor        # () i32: rounds actually run
    lb_history: torch.Tensor    # (R,) f32 per-round dual LB
    n_contracted: torch.Tensor  # (R,) i32 edges contracted per round
    n_clusters: torch.Tensor    # (R,) i32 live clusters after each round

    @property
    def history(self) -> list:
        """Per-round dicts rebuilt from the stacked arrays (syncs)."""
        r = int(self.rounds)
        return [{"round": i, "lb": float(self.lb_history[i]),
                 "n_contracted": int(self.n_contracted[i]),
                 "n_clusters": int(self.n_clusters[i])} for i in range(r)]


def resolve_mp(backend: str | None):
    """Map a backend name to the message-passing phase, a function
    (cost, edge_valid, tri, tri_valid, iters) → (t_cost, c_rep, lb)."""
    if backend == "reference":
        return mp_phase_per_edge
    if backend is None or backend == "cuda":
        from repro_torch.kernels.triangle_mp.ops import mp_phase
        return mp_phase
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


def resolve_intersect(backend: str | None):
    """Map a backend name to the sorted-row intersection of separation."""
    if backend == "reference":
        return None     # separate uses intersect_rows_ref
    if backend is None or backend == "cuda":
        from repro_torch.kernels.cycle_intersect.ops import intersect_rows
        return intersect_rows
    raise ValueError(f"unknown backend {backend!r}; expected one of "
                     f"{BACKENDS}")


class SolverState(NamedTuple):
    """Solver state threaded through the outer round loop: the current
    contracted instance, its live all-edges CSR (sparse path: built once,
    maintained by :func:`contract_csr`; None on the dense path), and the
    original→cluster mapping."""
    instance: MulticutInstance
    csr: CsrGraph | None
    mapping: torch.Tensor


def _dual_round_core(inst: MulticutInstance, cfg: SolverConfig,
                     with45: bool, mp=None, intersect=None, csr=None,
                     update_csr: bool = False):
    """One separation + message-passing round. Returns (inst', c_rep, lb,
    csr') — ``csr'`` is the chord-spliced all-edges CSR when
    ``update_csr`` (sparse path), else None. The ``repro.*`` ranges name
    the round's phases in a torch.profiler trace, as the reference's
    ``jax.named_scope``s do in its HLO."""
    with record_function("repro.separation"):
        sep = separate(inst, max_neg=cfg.max_neg,
                       max_tri_per_edge=cfg.max_tri_per_edge,
                       with_cycles45=with45, nbr_k=cfg.nbr_k,
                       graph_impl=cfg.graph_impl,
                       sparse_row_cap=cfg.sparse_row_cap,
                       sparse_row_cap_short=cfg.sparse_row_cap_short,
                       sparse_threshold=cfg.sparse_threshold,
                       intersect=intersect, csr=csr,
                       separation_chunk=cfg.separation_chunk,
                       separation_shards=cfg.separation_shards,
                       update_csr=update_csr)
    inst2 = sep.instance
    if mp is None:
        mp = mp_phase_per_edge
    with record_function("repro.message_passing"):
        _, c_rep, lb = mp(inst2.cost, inst2.edge_valid, sep.triangles.edges,
                          sep.triangles.valid, cfg.mp_iters)
    return inst2, c_rep, lb, sep.csr


def _contraction_set(inst: MulticutInstance, cfg: SolverConfig):
    return choose_contraction_set(inst, matching_rounds=cfg.matching_rounds,
                                  forest_rounds=cfg.forest_rounds,
                                  switch_frac=cfg.switch_frac,
                                  contract_frac=cfg.contract_frac)


def _primal_round_core(inst: MulticutInstance, cfg: SolverConfig):
    with record_function("repro.contraction"):
        return contract(inst, _contraction_set(inst, cfg))


def fused_pd_round(inst: MulticutInstance, cfg: SolverConfig, with45: bool,
                   mp=None, intersect=None):
    """Alg. 3 lines 3–8 as one unit: separation → message passing →
    reparametrise → contract. Returns (ContractionResult, lb)."""
    inst2, c_rep, lb, _ = _dual_round_core(inst, cfg, with45, mp,
                                           intersect)
    return _primal_round_core(inst2._replace(cost=c_rep), cfg), lb


def _dense_round_state(state: SolverState, cfg: SolverConfig, with45: bool,
                       mp=None, intersect=None):
    """:func:`fused_pd_round` in the shape of :func:`fused_pd_round_state`
    (the dense path carries no CSR)."""
    res, lb = fused_pd_round(state.instance, cfg, with45, mp, intersect)
    state2 = SolverState(instance=res.instance, csr=None,
                         mapping=res.mapping[state.mapping.long()])
    return state2, lb, res


def fused_pd_round_state(state: SolverState, cfg: SolverConfig, with45: bool,
                         mp=None, intersect=None):
    """The state-carrying PD round (sparse data path): separation reads the
    carried CSR, contraction maintains it, and the original→cluster mapping
    composes. Returns (SolverState', lb, ContractionResult)."""
    inst2, c_rep, lb, _ = _dual_round_core(state.instance, cfg, with45,
                                           mp, intersect, csr=state.csr)
    inst3 = inst2._replace(cost=c_rep)
    with record_function("repro.contraction"):
        res, csr2 = contract_csr(inst3, _contraction_set(inst3, cfg))
    state2 = SolverState(instance=res.instance, csr=csr2,
                         mapping=res.mapping[state.mapping.long()])
    return state2, lb, res


def _solve_p_device(inst: MulticutInstance, cfg: SolverConfig):
    """Purely primal Algorithm 1 loop (paper's P): contract until a round
    contracts nothing or ``max_rounds`` — one host sync per round. There is
    no dual: the lower bound and its history stay -inf."""
    N, R = inst.num_nodes, cfg.max_rounds
    dev = inst.device
    mapping = torch.arange(N, dtype=torch.int32, device=dev)
    hist_nc = torch.zeros((R,), dtype=torch.int32, device=dev)
    hist_nk = torch.zeros((R,), dtype=torch.int32, device=dev)
    cur = inst
    r = 0
    while r < R:
        res = _primal_round_core(cur, cfg)
        hist_nc[r] = res.n_contracted.to(torch.int32)
        hist_nk[r] = res.n_new.to(torch.int32)
        mapping = res.mapping[mapping.long()]
        cur = res.instance
        r += 1
        if int(res.n_contracted) == 0:
            break
    ninf = float("-inf")
    return SolveResult(
        labels=mapping, objective=inst.objective(mapping),
        lower_bound=torch.tensor(ninf, dtype=torch.float32, device=dev),
        rounds=torch.tensor(r, dtype=torch.int32, device=dev),
        lb_history=torch.full((R,), ninf, dtype=torch.float32, device=dev),
        n_contracted=hist_nc, n_clusters=hist_nk)


def _solve_pd_device(inst: MulticutInstance, cfg: SolverConfig, plus: bool,
                     mp=None, intersect=None):
    """Interleaved primal-dual Algorithm 3 (paper's PD / PD+) on either data
    path. The sparse path runs the :class:`SolverState` recursion:
    ``build_csr`` once, before round 0, and every later round reads the CSR
    the previous round's contraction maintained. The dense path rebuilds
    its (N, N) matrices each round, as the reference does. Round 0 may
    separate 4/5-cycles and gives the solve's lower bound (the only one
    valid on the original graph). The loop exits early when a round
    contracts nothing — one host sync per round."""
    N, R = inst.num_nodes, cfg.max_rounds
    dev = inst.device
    with45_first = cfg.always_cycles45 or plus or cfg.first_round_cycles45
    with45_rest = cfg.always_cycles45 or plus
    sparse = resolve_graph_impl(cfg.graph_impl, N,
                                cfg.sparse_threshold) == "sparse"
    step = fused_pd_round_state if sparse else _dense_round_state

    state = SolverState(
        instance=inst,
        csr=csr_from_instance(inst) if sparse else None,
        mapping=torch.arange(N, dtype=torch.int32, device=dev))
    hist_lb = torch.full((R,), float("-inf"), dtype=torch.float32,
                         device=dev)
    hist_nc = torch.zeros((R,), dtype=torch.int32, device=dev)
    hist_nk = torch.zeros((R,), dtype=torch.int32, device=dev)
    lb0 = None
    r = 0
    while r < R:
        state, lb, res = step(state, cfg,
                              with45_first if r == 0 else with45_rest,
                              mp, intersect)
        if r == 0:
            lb0 = lb
        hist_lb[r] = lb
        hist_nc[r] = res.n_contracted.to(torch.int32)
        hist_nk[r] = res.n_new.to(torch.int32)
        r += 1
        if int(res.n_contracted) == 0:
            break
    labels = state.mapping
    return SolveResult(labels=labels, objective=inst.objective(labels),
                       lower_bound=lb0.to(torch.float32),
                       rounds=torch.tensor(r, dtype=torch.int32, device=dev),
                       lb_history=hist_lb, n_contracted=hist_nc,
                       n_clusters=hist_nk)


def _solve_d_device(inst: MulticutInstance, cfg: SolverConfig, mp=None,
                    intersect=None):
    """Dual-only solver (paper's D): ``dual_rounds`` rounds of separation +
    message passing on the original graph; the LB is monotone across
    rounds. Returns (SolveResult, final instance).

    LB accounting: the MP phase returns lb_r = edgeLB_r + triLB_r; the
    triangle parts add up across rounds and only the last round's edge
    part counts, LB_total = Σ_r triLB_r + Σ_e min(0, c^rep_final). The
    edge part is a ``torch.sum``, in the device's reduction order, not the
    reference's: it feeds no decision, so only the bound's last bits can
    differ between devices. On the sparse path the
    all-edges CSR is built once and each round's fresh chords are spliced
    in (``update_csr``); the dense path has no CSR. A fixed number of
    rounds: no exit sync."""
    R = cfg.dual_rounds
    N = inst.num_nodes
    dev = inst.device
    sparse = resolve_graph_impl(cfg.graph_impl, N,
                                cfg.sparse_threshold) == "sparse"
    csr = csr_from_instance(inst) if sparse else None
    cur = inst
    tri_lb_sum = torch.zeros((), dtype=torch.float32, device=dev)
    per_round = []
    for _ in range(R):
        cur2, c_rep, lb, csr = _dual_round_core(cur, cfg, True, mp,
                                                intersect, csr=csr,
                                                update_csr=sparse)
        edge_lb = torch.where(cur2.edge_valid,
                              torch.clamp(c_rep, max=0.0),
                              torch.zeros_like(c_rep)).sum()
        tri_lb_sum = tri_lb_sum + (lb - edge_lb)
        per_round.append(tri_lb_sum + edge_lb)
        cur = cur2._replace(cost=c_rep)
    lb_history = torch.stack(per_round).to(torch.float32)
    n_nodes = inst.node_valid.sum().to(torch.int32)
    res = SolveResult(
        labels=torch.arange(N, dtype=torch.int32, device=dev),
        objective=torch.tensor(float("inf"), dtype=torch.float32,
                               device=dev),
        lower_bound=lb_history[-1],
        rounds=torch.tensor(R, dtype=torch.int32, device=dev),
        lb_history=lb_history,
        n_contracted=torch.zeros((R,), dtype=torch.int32, device=dev),
        n_clusters=n_nodes.expand(R).clone())
    return res, cur


def solve_device(inst: MulticutInstance, mode: str = "pd",
                 cfg: SolverConfig = SolverConfig(),
                 mp=None, intersect=None, trace: bool = False):
    """Solve on the instance's device: every mode on both data paths
    (``cfg.graph_impl``). What is not ported yet raises
    ``NotImplementedError`` naming its ROADMAP item."""
    if cfg.graph_impl not in GRAPH_IMPLS:
        raise ValueError(f"unknown graph_impl {cfg.graph_impl!r}; expected "
                         f"one of {GRAPH_IMPLS}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if trace:
        raise NotImplementedError(
            "trace=True is not ported yet (ROADMAP Queue 1 item 9)")
    if cfg.state_shards:
        raise NotImplementedError(
            "state_shards is not ported yet (ROADMAP Queue 1 item 13)")
    if cfg.separation_shards > 1:
        raise NotImplementedError(
            "separation_shards > 1 is not ported yet (ROADMAP Queue 1 "
            "item 13)")
    if mode == "p":
        return _solve_p_device(inst, cfg)
    if mode == "d":
        return _solve_d_device(inst, cfg, mp, intersect)[0]
    return _solve_pd_device(inst, cfg, plus=(mode == "pd+"), mp=mp,
                            intersect=intersect)
