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
components and long-bucket separation pass add their own; each is counted
where it happens (``solver_syncs_total`` in
:func:`repro_torch.obs.solver_metrics`). D is a fixed number of rounds
and needs no exit sync. CUDA graphs come later.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.contraction import choose_contraction_set, \
    contract, contract_csr
from repro_torch.core.cycles import separate
from repro_torch.core.graph import (
    DEFAULT_SPARSE_THRESHOLD, GRAPH_IMPLS, CsrGraph, MulticutInstance,
    csr_from_instance, resolve_graph_impl,
)
from repro_torch.core.message_passing import mp_phase_per_edge
from repro_torch.obs.trace import init_trace, trace_set_round

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
                     update_csr: bool = False, node_mask=None,
                     with_aux: bool = False):
    """One separation + message-passing round. Returns (inst', c_rep, lb,
    csr') — ``csr'`` is the chord-spliced all-edges CSR when
    ``update_csr`` (sparse path), else None. ``node_mask`` restricts the
    round's repulsive edges to a frontier. The ``repro.*`` ranges name
    the round's phases in a torch.profiler trace, as the reference's
    ``jax.named_scope``s do in its HLO; :func:`repro_torch.obs.phase`
    opens them, with the phases' spans.

    ``with_aux`` appends a telemetry tuple ``(n_cycles,
    mp_improvement)``: conflicted cycles found by separation, and the LB
    gain of the MP phase over the trivial bound Σ_e min(0, c) on the
    round's pre-MP costs. Both only read what the round produced; the sum
    is a ``torch.sum`` that feeds no decision."""
    with obs.phase("separation", range="repro.separation"):
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
                       sep_node_mask=node_mask, update_csr=update_csr)
    inst2 = sep.instance
    if mp is None:
        mp = mp_phase_per_edge
    with obs.phase("message_passing", range="repro.message_passing"):
        _, c_rep, lb = mp(inst2.cost, inst2.edge_valid, sep.triangles.edges,
                          sep.triangles.valid, cfg.mp_iters)
    if not with_aux:
        return inst2, c_rep, lb, sep.csr
    n_cyc = sep.triangles.valid.sum().to(torch.int32)
    trivial_lb = torch.where(inst2.edge_valid,
                             torch.clamp(inst2.cost, max=0.0),
                             torch.zeros_like(inst2.cost)).sum()
    return inst2, c_rep, lb, sep.csr, (n_cyc, lb - trivial_lb)


def _contraction_set(inst: MulticutInstance, cfg: SolverConfig):
    return choose_contraction_set(inst, matching_rounds=cfg.matching_rounds,
                                  forest_rounds=cfg.forest_rounds,
                                  switch_frac=cfg.switch_frac,
                                  contract_frac=cfg.contract_frac)


def _primal_round_core(inst: MulticutInstance, cfg: SolverConfig):
    with obs.phase("contraction", range="repro.contraction"):
        return contract(inst, _contraction_set(inst, cfg))


def fused_pd_round(inst: MulticutInstance, cfg: SolverConfig, with45: bool,
                   mp=None, intersect=None, node_mask=None,
                   with_aux: bool = False):
    """Alg. 3 lines 3–8 as one unit: separation → message passing →
    reparametrise → contract. Returns (ContractionResult, lb), plus the
    telemetry aux of :func:`_dual_round_core` when ``with_aux``."""
    out = _dual_round_core(inst, cfg, with45, mp, intersect,
                           node_mask=node_mask, with_aux=with_aux)
    res = _primal_round_core(out[0]._replace(cost=out[1]), cfg)
    return (res, out[2], out[4]) if with_aux else (res, out[2])


def _dense_round_state(state: SolverState, cfg: SolverConfig, with45: bool,
                       mp=None, intersect=None, node_mask=None,
                       with_aux: bool = False):
    """:func:`fused_pd_round` in the shape of :func:`fused_pd_round_state`
    (the dense path carries no CSR)."""
    out = fused_pd_round(state.instance, cfg, with45, mp, intersect,
                         node_mask, with_aux)
    res = out[0]
    state2 = SolverState(instance=res.instance, csr=None,
                         mapping=res.mapping[state.mapping.long()])
    return (state2, out[1], res) + out[2:]


def fused_pd_round_state(state: SolverState, cfg: SolverConfig, with45: bool,
                         mp=None, intersect=None, node_mask=None,
                         with_aux: bool = False):
    """The state-carrying PD round (sparse data path): separation reads the
    carried CSR, contraction maintains it, and the original→cluster mapping
    composes. Returns (SolverState', lb, ContractionResult), plus the
    telemetry aux of :func:`_dual_round_core` when ``with_aux``."""
    out = _dual_round_core(state.instance, cfg, with45, mp, intersect,
                           csr=state.csr, node_mask=node_mask,
                           with_aux=with_aux)
    inst3 = out[0]._replace(cost=out[1])
    with obs.phase("contraction", range="repro.contraction"):
        res, csr2 = contract_csr(inst3, _contraction_set(inst3, cfg))
    state2 = SolverState(instance=res.instance, csr=csr2,
                         mapping=res.mapping[state.mapping.long()])
    return (state2, out[2], res) + out[4:]


def _live_edges1(inst: MulticutInstance) -> torch.Tensor:
    """(1,) i32 live-edge count: the S = 1 row of SolveTrace.shard_edges."""
    return inst.edge_valid.sum().to(torch.int32).reshape(1)


def _exit_read(n_contracted: torch.Tensor) -> bool:
    """Whether the round contracted nothing: the round's one host sync
    (site ``round_exit``)."""
    obs.count_sync("round_exit", n_contracted.device)
    return int(n_contracted) == 0


def _host_scalar(value, dtype, dev) -> torch.Tensor:
    """A 0-d tensor of a host number on ``dev``: a host-to-device copy that
    waits for the device (site ``result_scalar``)."""
    obs.count_sync("result_scalar", torch.device(dev))
    return torch.tensor(value, dtype=dtype, device=dev)


def _solve_p_device(inst: MulticutInstance, cfg: SolverConfig,
                    trace: bool = False):
    """Purely primal Algorithm 1 loop (paper's P): contract until a round
    contracts nothing or ``max_rounds`` — one host sync per round. There is
    no dual: the lower bound and its history stay -inf.

    ``trace`` also fills a :class:`SolveTrace` row a round (objective,
    contraction and cluster counts, live edges) and returns
    ``(SolveResult, SolveTrace)``; its writes stay on the device."""
    N, R = inst.num_nodes, cfg.max_rounds
    dev = inst.device
    mapping = torch.arange(N, dtype=torch.int32, device=dev)
    hist_nc = torch.zeros((R,), dtype=torch.int32, device=dev)
    hist_nk = torch.zeros((R,), dtype=torch.int32, device=dev)
    tr = init_trace(R, device=dev) if trace else None
    cur = inst
    r = 0
    while r < R:
        with obs.phase("round", r=r, slots=cur.num_edges) as rnd:
            if rnd:
                rnd.set(live_edges=cur.edge_valid.sum())
            res = _primal_round_core(cur, cfg)
            hist_nc[r] = res.n_contracted.to(torch.int32)
            hist_nk[r] = res.n_new.to(torch.int32)
            mapping = res.mapping[mapping.long()]
            cur = res.instance
            if trace:
                trace_set_round(tr, r, objective=inst.objective(mapping),
                                n_contracted=hist_nc[r],
                                n_clusters=hist_nk[r],
                                shard_edges=_live_edges1(cur))
            r += 1
            done = _exit_read(res.n_contracted)
        if done:
            break
    ninf = float("-inf")
    out = SolveResult(
        labels=mapping, objective=inst.objective(mapping),
        lower_bound=_host_scalar(ninf, torch.float32, dev),
        rounds=_host_scalar(r, torch.int32, dev),
        lb_history=torch.full((R,), ninf, dtype=torch.float32, device=dev),
        n_contracted=hist_nc, n_clusters=hist_nk)
    return (out, tr) if trace else out


def _solve_pd_device(inst: MulticutInstance, cfg: SolverConfig, plus: bool,
                     mp=None, intersect=None, csr0=None, sep_mask0=None,
                     trace: bool = False):
    """Interleaved primal-dual Algorithm 3 (paper's PD / PD+) on either data
    path. The sparse path runs the :class:`SolverState` recursion:
    ``build_csr`` once, before round 0, and every later round reads the CSR
    the previous round's contraction maintained. The dense path rebuilds
    its (N, N) matrices each round, as the reference does. Round 0 may
    separate 4/5-cycles and gives the solve's lower bound (the only one
    valid on the original graph). The loop exits early when a round
    contracts nothing — one host sync per round.

    Delta re-solves seed the solve: ``csr0`` is a live all-edges CSR of
    ``inst`` that replaces the sparse path's initial ``build_csr`` (the
    dense path has no CSR to carry and ignores it), and ``sep_mask0``
    restricts round 0's separation to a frontier on both paths.

    ``trace`` also fills a :class:`SolveTrace` row a round (bound,
    objective of the labelling after the round, cycles, contraction and
    cluster counts, MP gain, live edges) and returns ``(SolveResult,
    SolveTrace)``. Its writes and its one extra reduction a round (the
    objective) stay on the device: no extra host sync."""
    N, R = inst.num_nodes, cfg.max_rounds
    dev = inst.device
    with45_first = cfg.always_cycles45 or plus or cfg.first_round_cycles45
    with45_rest = cfg.always_cycles45 or plus
    sparse = resolve_graph_impl(cfg.graph_impl, N,
                                cfg.sparse_threshold) == "sparse"
    step = fused_pd_round_state if sparse else _dense_round_state

    state = SolverState(
        instance=inst,
        csr=(csr_from_instance(inst) if csr0 is None else csr0)
        if sparse else None,
        mapping=torch.arange(N, dtype=torch.int32, device=dev))
    hist_lb = torch.full((R,), float("-inf"), dtype=torch.float32,
                         device=dev)
    hist_nc = torch.zeros((R,), dtype=torch.int32, device=dev)
    hist_nk = torch.zeros((R,), dtype=torch.int32, device=dev)
    tr = init_trace(R, device=dev) if trace else None
    lb0 = None
    r = 0
    while r < R:
        with obs.phase("round", r=r,
                       slots=state.instance.num_edges) as rnd:
            if rnd:
                rnd.set(live_edges=state.instance.edge_valid.sum())
            out = step(state, cfg, with45_first if r == 0 else with45_rest,
                       mp, intersect,
                       node_mask=sep_mask0 if r == 0 else None,
                       with_aux=trace)
            state, lb, res = out[:3]
            if r == 0:
                lb0 = lb
            hist_lb[r] = lb
            hist_nc[r] = res.n_contracted.to(torch.int32)
            hist_nk[r] = res.n_new.to(torch.int32)
            if trace:
                n_cyc, mp_gain = out[3]
                trace_set_round(tr, r, lower_bound=hist_lb[r],
                                objective=inst.objective(state.mapping),
                                n_cycles=n_cyc, n_contracted=hist_nc[r],
                                n_clusters=hist_nk[r],
                                mp_improvement=mp_gain,
                                shard_edges=_live_edges1(state.instance))
            r += 1
            done = _exit_read(res.n_contracted)
        if done:
            break
    labels = state.mapping
    res = SolveResult(labels=labels, objective=inst.objective(labels),
                      lower_bound=lb0.to(torch.float32),
                      rounds=_host_scalar(r, torch.int32, dev),
                      lb_history=hist_lb, n_contracted=hist_nc,
                      n_clusters=hist_nk)
    return (res, tr) if trace else res


def _solve_d_device(inst: MulticutInstance, cfg: SolverConfig, mp=None,
                    intersect=None, trace: bool = False):
    """Dual-only solver (paper's D): ``dual_rounds`` rounds of separation +
    message passing on the original graph; the LB is monotone across
    rounds. Returns (SolveResult, final instance, SolveTrace or None).

    LB accounting: the MP phase returns lb_r = edgeLB_r + triLB_r; the
    triangle parts add up across rounds and only the last round's edge
    part counts, LB_total = Σ_r triLB_r + Σ_e min(0, c^rep_final). The
    edge part is a ``torch.sum``, in the device's reduction order, not the
    reference's: it feeds no decision, so only the bound's last bits can
    differ between devices. On the sparse path the
    all-edges CSR is built once and each round's fresh chords are spliced
    in (``update_csr``); the dense path has no CSR. A fixed number of
    rounds: no exit sync.

    With ``trace`` the rounds' cycle counts and MP gains are kept as
    tensors and the trace is assembled after the loop, as the reference
    assembles its scan's outputs; D has no primal, so the objective rows
    stay padding."""
    R = cfg.dual_rounds
    N = inst.num_nodes
    dev = inst.device
    sparse = resolve_graph_impl(cfg.graph_impl, N,
                                cfg.sparse_threshold) == "sparse"
    csr = csr_from_instance(inst) if sparse else None
    cur = inst
    tri_lb_sum = torch.zeros((), dtype=torch.float32, device=dev)
    per_round = []
    aux = []
    for r in range(R):
        with obs.phase("round", r=r, slots=cur.num_edges) as rnd:
            if rnd:
                rnd.set(live_edges=cur.edge_valid.sum())
            out = _dual_round_core(cur, cfg, True, mp, intersect, csr=csr,
                                   update_csr=sparse, with_aux=trace)
            cur2, c_rep, lb, csr = out[:4]
            aux.extend(out[4:])
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
        objective=_host_scalar(float("inf"), torch.float32, dev),
        lower_bound=lb_history[-1],
        rounds=_host_scalar(R, torch.int32, dev),
        lb_history=lb_history,
        n_contracted=torch.zeros((R,), dtype=torch.int32, device=dev),
        n_clusters=n_nodes.expand(R).clone())
    tr = None
    if trace:
        tr = init_trace(R, device=dev)._replace(
            rounds=torch.full((), R, dtype=torch.int32, device=dev),
            lower_bound=lb_history.clone(),
            n_cycles=torch.stack([c for c, _ in aux]),
            mp_improvement=torch.stack([g for _, g in aux]).to(
                torch.float32),
            n_clusters=res.n_clusters.clone(),
            shard_edges=_live_edges1(inst).expand(R, 1).clone())
    return res, cur, tr


def solve_device(inst: MulticutInstance, mode: str = "pd",
                 cfg: SolverConfig = SolverConfig(),
                 mp=None, intersect=None, trace: bool = False, csr=None,
                 sep_node_mask=None):
    """Solve on the instance's device: every mode on both data paths
    (``cfg.graph_impl``). ``cfg.state_shards`` routes mode pd to the
    edge-range-sharded solve (:func:`repro_torch.core.sharded.
    solve_state_sharded`; every rank of the default process group calls
    it, and ``inst`` may be the rank's ``EdgeRange``);
    ``separation_shards`` spreads each sparse separation's candidate
    phase over that many cards (clamped to those present; bit-identical
    to one).

    ``csr``/``sep_node_mask`` seed delta re-solves in modes pd and pd+
    (see :func:`_solve_pd_device`); modes p and d ignore both.

    ``trace=True`` returns ``(SolveResult, SolveTrace)``: per-round
    telemetry (:mod:`repro_torch.obs.trace`) written on the device as the
    rounds run, with no extra host sync; the result is bit-identical to
    the untraced solve's.

    While tracing is on (:mod:`repro_torch.obs.phases`) the solve is one
    ``solve`` span (the mode, padded nodes and edge slots, and the change
    of the solve path's sync counter over the solve) over a ``round`` span
    a round; the result is the same bit for bit."""
    if cfg.graph_impl not in GRAPH_IMPLS:
        raise ValueError(f"unknown graph_impl {cfg.graph_impl!r}; expected "
                         f"one of {GRAPH_IMPLS}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if cfg.state_shards and (csr is not None or sep_node_mask is not None):
        raise ValueError("state_shards does not take warm-start seeds "
                         "(csr/sep_node_mask): the carried CSR is "
                         "per-shard with local edge ids, not the "
                         "replicated one delta re-solves splice")
    if cfg.state_shards and mode in ("p", "d"):
        raise ValueError(
            f"state_shards requires mode='pd' (got {mode!r}); the sharded "
            f"solve supports 3-cycle separation only, and p/d have no "
            f"edge-partitioned round to run")
    with obs.phase("solve", device=inst.device, mode=mode,
                   nodes=inst.num_nodes, slots=inst.num_edges):
        if cfg.state_shards:
            from repro_torch.core.sharded import solve_state_sharded
            return solve_state_sharded(inst, cfg, mode=mode, mp=mp,
                                       intersect=intersect, trace=trace)
        if mode == "p":
            return _solve_p_device(inst, cfg, trace=trace)
        if mode == "d":
            res, _, tr = _solve_d_device(inst, cfg, mp, intersect,
                                         trace=trace)
            return (res, tr) if trace else res
        return _solve_pd_device(inst, cfg, plus=(mode == "pd+"), mp=mp,
                                intersect=intersect, csr0=csr,
                                sep_mask0=sep_node_mask, trace=trace)


# ---------------------------------------------------------------------------
# Round entry points of the arch config (configs/rama_multicut.py)
# ---------------------------------------------------------------------------

def _dual_round(inst: MulticutInstance, mp_iters: int, max_neg: int,
                max_tri_per_edge: int, nbr_k: int, with_cycles45: bool,
                mp=None, intersect=None):
    """One separation + message-passing round on the dense data path (the
    reference's ``separate`` default). Returns (inst', c_rep, lb).
    ``mp``/``intersect`` are the phase functions :func:`resolve_mp` and
    :func:`resolve_intersect` give (the per-edge MP by default)."""
    cfg = SolverConfig(mp_iters=mp_iters, max_neg=max_neg,
                       max_tri_per_edge=max_tri_per_edge, nbr_k=nbr_k,
                       graph_impl="dense")
    return _dual_round_core(inst, cfg, with_cycles45, mp, intersect)[:3]


def _primal_round(inst: MulticutInstance, matching_rounds: int,
                  forest_rounds: int, switch_frac: float,
                  contract_frac: float = 0.0):
    """One contraction round: the contraction set, then ``contract``.
    Returns the ContractionResult."""
    return _primal_round_core(inst, SolverConfig(
        matching_rounds=matching_rounds, forest_rounds=forest_rounds,
        switch_frac=switch_frac, contract_frac=contract_frac))
