"""The serving engine: admission → bucketed queues → micro-batched
dispatch → harvest → demux (port of ``repro.serve.engine``).

:class:`SolveEngine` turns a stream of arbitrary-size multicut requests
into work for a fixed set of registry entries:

1. **Admission** (:meth:`SolveEngine.submit`): the request's instance is
   moved to the engine's device, routed (:class:`Router` picks mode /
   config / backend / batch_shards from its size — or, with
   ``adaptive_routing=True``, from the measured per-slot wall EMA of each
   candidate route on the request's bucket, falling back to the static
   table until every candidate is warm) and bucketed
   (:class:`BucketPolicy`), then parked on the queue keyed by
   ``(bucket, route)``. Instances over the policy caps are rejected here.
   Requests may carry a relative ``deadline_s``. On sparse-routed buckets
   the engine also tunes ``SolverConfig.sparse_row_cap_short`` from the
   first instance seen (p95 of its attractive degree, clamped to
   ``[8, sparse_row_cap]``); results are bit-identical for any value.
2. **Micro-batching** (:meth:`SolveEngine.pump`): a queue dispatches as
   soon as it holds ``batch_cap`` requests; a non-empty queue flushes
   partially when its head has waited ``flush_timeout_s`` *or* when its
   earliest deadline minus the route's EMA wall is about to pass
   (tightest-deadline queues first). Partial flushes decompose over the
   power-of-two sub-batch ladder (:func:`batch_ladder`) instead of
   padding to ``batch_cap``.
3. **Dispatch** goes through :func:`repro_torch.api.compiled_solve` — the
   registry behind ``api.solve`` — as one batched call per (bucket,
   route); a route with ``batch_shards`` > 1 gets the sharded entry,
   which solves slice r of the batch on card r and gathers the slices
   back before it records its event. The engine parks each dispatch on a
   per-backend in-flight window (``max_inflight`` deep) and **harvests**
   it on a later pump, once the CUDA event recorded after it completes
   (:func:`repro_torch.api.tree_ready`); a full window back-pressures by
   waiting on its oldest entry. ``max_inflight=0`` is the synchronous
   engine; per-request results are bit-identical either way, because the
   window reorders only waiting. The port's solve syncs with the host
   every round, so a dispatch returns when its work is nearly done and
   the window overlaps little today.
4. **Demux** (at harvest): the batched :class:`SolveResult` is sliced per
   slot, filler slots dropped, node padding stripped, and each ticket
   resolved. Results equal ``api.solve`` of the same bucket-padded
   instance bit for bit, because a batched entry solves slot by slot.
   Harvest also feeds the per-(bucket, route) wall EMAs and the deadline
   counters.

Compile accounting: ``stats.compiles`` counts the first calls of registry
entries at new shapes (``api.trace_count``); a stream costs at most
``len(buckets) × len(routes) × len(batch ladder)`` of them.

**Sticky delta sessions** ride the same machinery: ``open_session`` cold
solves an instance (routed as "delta" traffic) and parks its
:class:`repro_torch.incremental.DeltaState` in a :class:`DeltaSession`;
``submit_delta`` queues a patch tick under the session's (bucket, route,
warm) key, micro-batched with other sessions' ticks; the demux writes each
updated state back to its session. A session's own ticks are serialised;
different sessions' ticks batch and overlap. Delta dispatches keep the
fixed ``batch_cap`` axis (their filler is a cached empty-patch state).
With ``max_sessions`` set, opening a session past the cap evicts the
least recently used one (settling its tick first).

The engine is single-threaded. ``clock`` and ``ready_fn`` are injectable
so timeout, deadline and harvest behaviour are testable without sleeping.
``device`` (default ``"cuda"``) is where requests are solved; without a
card the engine raises unless given ``device="cpu"``.

**Observability** (:mod:`repro_torch.obs`): every engine owns a
:class:`MetricsRegistry` (``engine.metrics``): the latency histogram,
queue/in-flight/occupancy/deadline gauges and the registry's compile
accounting — :meth:`SolveEngine.metrics_snapshot` (JSON) or
:meth:`SolveEngine.metrics_prometheus`. ``tracer=SpanRecorder()``
records the request lifecycle as Chrome-trace spans (one lane per
request); ``tracer=None`` keeps every recording site behind one
``is not None`` check.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from collections import deque

import torch

from repro_torch import api
from repro_torch.core.dist import resolve_batch_shards
from repro_torch.core.graph import (
    ROW_CAP_FLOOR, MulticutInstance, attractive_degree_p95,
    resolve_graph_impl,
)
from repro_torch.core.solver import SolveResult
from repro_torch.incremental.patch import DeltaPatch, make_patch, pad_patch
from repro_torch.incremental.state import init_delta_state
from repro_torch.obs import register_compile_metrics
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.spans import SpanRecorder
from repro_torch.serve.buckets import (
    Bucket, BucketPolicy, batch_ladder, decompose_batch, filler_instance,
    pad_batch, pad_instance, strip_result,
)
from repro_torch.serve.router import Route, Router, default_router
from repro_torch.serve.session import DeltaSession, SessionStore
from repro_torch.tree import tree_map

__all__ = ["DeltaTicket", "EngineStats", "RouteWall", "SolveEngine",
           "SolveTicket"]


EMA_ALPHA = 0.4             # wall-clock EMA smoothing: heavy enough to
                            # forget the first (kernel-building) dispatches
                            # within a few samples, light enough not to
                            # chase per-dispatch jitter


@dataclasses.dataclass
class RouteWall:
    """Measured wall-clock for one (bucket, route[, warm]) registry entry:
    EMAs of the per-dispatch wall and the per-*slot* wall (wall divided
    by the dispatch's batch slots — the unit adaptive routing compares
    across routes, since different routes may flush different sizes)."""
    ema_wall_s: float = 0.0
    ema_slot_s: float = 0.0
    n: int = 0


@dataclasses.dataclass
class EngineStats:
    """Counters the benchmarks and tests read; all cumulative except
    ``latency_hist`` (a bounded log-bucketed histogram of end-to-end
    request latencies — O(1) memory, percentiles via
    ``latency_hist.percentile(p)`` with a proven ≤ 9.06% relative error;
    see :class:`repro_torch.obs.metrics.Histogram`) and ``route_walls``
    (per-entry wall EMAs, see :class:`RouteWall`)."""
    n_submitted: int = 0
    n_completed: int = 0
    n_dispatches: int = 0
    n_filler_slots: int = 0     # batch slots served to padding, not requests
    compiles: int = 0           # registry first-calls at new shapes
    n_sessions_opened: int = 0
    n_sessions_evicted: int = 0  # LRU evictions under max_sessions
    n_delta_submitted: int = 0
    n_delta_completed: int = 0
    n_delta_dispatches: int = 0
    n_delta_filler_slots: int = 0
    n_deadlined: int = 0        # requests submitted with a deadline
    n_deadline_missed: int = 0  # ... that completed after it passed
    inflight_high_water: int = 0
    latency_hist: Histogram = dataclasses.field(
        default_factory=lambda: Histogram(
            "request_latency_seconds",
            "end-to-end request latency (submit to result demuxed)"))
    route_walls: dict = dataclasses.field(default_factory=dict)

    @property
    def occupancy(self) -> float:
        """Fraction of dispatched batch slots that held real requests."""
        total = self.n_completed + self.n_filler_slots
        return self.n_completed / total if total else 0.0

    @property
    def deadline_miss_rate(self) -> float:
        """Fraction of deadlined requests that missed (0 when none)."""
        return (self.n_deadline_missed / self.n_deadlined
                if self.n_deadlined else 0.0)

    def record_wall(self, key, wall_s: float, slots: int) -> None:
        """Fold one harvested dispatch into the key's wall EMAs."""
        rw = self.route_walls.get(key)
        if rw is None:
            self.route_walls[key] = RouteWall(
                ema_wall_s=wall_s, ema_slot_s=wall_s / slots, n=1)
        else:
            rw.ema_wall_s += EMA_ALPHA * (wall_s - rw.ema_wall_s)
            rw.ema_slot_s += EMA_ALPHA * (wall_s / slots - rw.ema_slot_s)
            rw.n += 1

    def wall_ema(self, key) -> float | None:
        """Expected per-dispatch wall for the key (None until sampled) —
        what deadline pressure subtracts from the earliest deadline."""
        rw = self.route_walls.get(key)
        return rw.ema_wall_s if rw is not None else None

    def slot_ema(self, key, min_samples: int = 1) -> float | None:
        """Per-slot wall EMA, or None until ``min_samples`` dispatches
        have been measured — the adaptive router's comparison unit."""
        rw = self.route_walls.get(key)
        return (rw.ema_slot_s
                if rw is not None and rw.n >= min_samples else None)


class SolveTicket:
    """Handle for one submitted request. ``result()`` blocks the caller's
    Python thread by pumping the engine until this request's batch has
    been dispatched (force-flushing its queue if the stream has gone
    quiet) and harvested, then returns the padding-stripped
    :class:`SolveResult`."""

    __slots__ = ("inst", "bucket", "route", "t_submit", "t_done",
                 "deadline", "req_id", "_result", "_engine", "_key")

    def __init__(self, engine: "SolveEngine", inst: MulticutInstance,
                 bucket: Bucket, route: Route, t_submit: float,
                 deadline: float | None = None, req_id: int = 0):
        self._engine = engine
        self.inst = inst
        self.bucket = bucket
        self.route = route
        self.t_submit = t_submit
        self.deadline = deadline        # absolute (engine-clock) or None
        self.req_id = req_id            # engine-assigned monotonic id; the
                                        # span lane every trace event of
                                        # this request records under
        self.t_done: float | None = None
        self._result: SolveResult | None = None
        self._key = (bucket, route)

    @property
    def done(self) -> bool:
        return self._result is not None

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit

    def result(self) -> SolveResult:
        if self._result is None:
            self._engine.pump()
        if self._result is None:        # partial batch: force my queue out
            self._engine.flush(self._key)
        if self._result is None:        # dispatched but in flight: wait
            self._engine._drain_ticket(self)
        assert self._result is not None
        return self._result


class DeltaTicket:
    """Handle for one submitted delta tick. Mirrors :class:`SolveTicket`
    (``result()`` pumps, force-flushes its own queue, then waits out the
    in-flight window); resolving it also writes the updated state back
    into the session."""

    __slots__ = ("session", "patch", "t_submit", "t_done", "deadline",
                 "req_id", "_result", "_engine", "_key")

    def __init__(self, engine: "SolveEngine", session: DeltaSession,
                 patch: DeltaPatch, t_submit: float,
                 deadline: float | None = None, req_id: int = 0):
        self._engine = engine
        self.session = session
        self.patch = patch
        self.t_submit = t_submit
        self.deadline = deadline
        self.req_id = req_id
        self.t_done: float | None = None
        self._result: SolveResult | None = None
        self._key = session.key

    @property
    def done(self) -> bool:
        return self._result is not None

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit

    def result(self) -> SolveResult:
        if self._result is None:
            self._engine.pump()
        if self._result is None:
            self._engine.flush_deltas(self._key)
        if self._result is None:
            self._engine._drain_ticket(self)
        assert self._result is not None
        return self._result


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unharvested batch: its results (their CUDA event
    maybe not reached yet) plus everything demux needs."""
    kind: str                   # "solve" | "delta"
    key: tuple                  # the queue key it dispatched under
    ema_key: tuple              # the (bucket, STATIC route[, warm]) the
                                # wall EMA records under — tuned routes
                                # fold into their static parent so
                                # adaptive routing compares like to like
    tickets: list
    res: object                 # batched SolveResult (maybe not ready)
    states2: object | None      # batched DeltaState for delta dispatches
    t_dispatch: float
    n_slots: int                # batch axis of this dispatch (ladder rung)


class SolveEngine:
    """Bucketed, routed, micro-batching, deadline-aware front end over
    the registry. See the module docstring for the pipeline; construction
    is cheap (entries build lazily on first dispatch, or eagerly via
    :meth:`warmup`).

    Async knobs: ``max_inflight`` bounds the per-backend window of
    dispatched-but-unharvested batches (0 = synchronous engine);
    ``adaptive_routing`` switches admission from the static size table to
    measured wall EMAs (see :meth:`Router.route_adaptive`);
    ``min_route_samples`` is how warm every candidate
    must be before adaptation kicks in; ``tune_short_cap`` enables the
    per-bucket ``sparse_row_cap_short`` self-tuning; ``max_sessions``
    LRU-bounds resident delta sessions; ``ready_fn`` overrides the
    readiness probe (tests inject flags here); ``device`` is where
    requests are solved (default ``"cuda"``).

    Observability knobs: ``tracer`` (a :class:`SpanRecorder`, default
    None = off) records request-lifecycle spans; ``metrics`` adopts an
    external :class:`MetricsRegistry` (default: the engine builds its
    own, at ``engine.metrics``)."""

    def __init__(self, router: Router | None = None,
                 policy: BucketPolicy | None = None, batch_cap: int = 8,
                 flush_timeout_s: float | None = 0.05, clock=time.monotonic,
                 patch_cap: int = 64, max_inflight: int = 4,
                 adaptive_routing: bool = False, min_route_samples: int = 3,
                 tune_short_cap: bool = True,
                 max_sessions: int | None = None, ready_fn=None,
                 tracer: SpanRecorder | None = None,
                 metrics: MetricsRegistry | None = None, device="cuda"):
        if batch_cap < 1:
            raise ValueError(f"batch_cap must be >= 1, got {batch_cap}")
        if patch_cap < 1:
            raise ValueError(f"patch_cap must be >= 1, got {patch_cap}")
        if max_inflight < 0:
            raise ValueError(f"max_inflight must be >= 0, got "
                             f"{max_inflight}")
        if max_sessions is not None and max_sessions < 1:
            raise ValueError(f"max_sessions must be >= 1 (or None), got "
                             f"{max_sessions}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SolveEngine serves on a CUDA device by default and none is "
                "available; pass device='cpu' to serve the plain PyTorch "
                "versions on the CPU")
        self.router = router if router is not None else default_router()
        self.policy = policy if policy is not None else BucketPolicy()
        self.batch_cap = batch_cap
        self.patch_cap = patch_cap
        self.flush_timeout_s = flush_timeout_s
        self.max_inflight = max_inflight
        self.adaptive_routing = adaptive_routing
        self.min_route_samples = min_route_samples
        self.tune_short_cap = tune_short_cap
        self.max_sessions = max_sessions
        self._clock = clock
        self._ready = ready_fn if ready_fn is not None else api.tree_ready
        self._queues: dict[tuple[Bucket, Route], deque[SolveTicket]] = {}
        self._delta_queues: dict[tuple[Bucket, Route, bool],
                                 deque[DeltaTicket]] = {}
        self._inflight: dict[str, deque[_InFlight]] = {}
        self._filler_states: dict[Bucket, object] = {}
        self._ladders: dict[Route, tuple[int, ...]] = {}
        self._tuned_routes: dict[tuple[Bucket, Route], Route] = {}
        self._static_route: dict[Route, Route] = {}
        self.sessions = SessionStore()
        self.stats = EngineStats()
        self.tracer = tracer
        self._req_ids = itertools.count(1)      # 0 is the engine span lane
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Wire the registry: the latency histogram plus callback gauges
        over live engine state — scraped values are read at collection
        time from ``stats``/queues, so there is no second bookkeeping
        path — and the api-level compile accounting
        (:func:`repro_torch.obs.register_compile_metrics`)."""
        reg, st = self.metrics, self.stats
        reg.register(st.latency_hist)
        reg.gauge("engine_queue_depth",
                  "requests queued, not yet dispatched",
                  fn=lambda: self.pending)
        reg.gauge("engine_inflight",
                  "dispatches issued, not yet harvested",
                  fn=lambda: self.inflight)
        reg.gauge("engine_inflight_high_water",
                  "max concurrent in-flight dispatches seen",
                  fn=lambda: st.inflight_high_water)
        reg.gauge("engine_occupancy",
                  "fraction of dispatched batch slots holding real "
                  "requests",
                  fn=lambda: st.occupancy)
        reg.gauge("engine_requests_submitted",
                  "solve requests admitted", fn=lambda: st.n_submitted)
        reg.gauge("engine_requests_completed",
                  "solve requests demuxed", fn=lambda: st.n_completed)
        reg.gauge("engine_dispatches",
                  "solve batches dispatched", fn=lambda: st.n_dispatches)
        reg.gauge("engine_filler_slots",
                  "batch slots served to padding",
                  fn=lambda: st.n_filler_slots)
        reg.gauge("engine_deadline_missed",
                  "deadlined requests completed past their deadline",
                  fn=lambda: st.n_deadline_missed)
        reg.gauge("engine_deadline_miss_rate",
                  "fraction of deadlined requests that missed",
                  fn=lambda: st.deadline_miss_rate)
        reg.gauge("engine_sessions_open",
                  "resident delta sessions", fn=lambda: len(self.sessions))
        reg.gauge("engine_sessions_evicted",
                  "LRU session evictions under max_sessions",
                  fn=lambda: st.n_sessions_evicted)
        reg.gauge("engine_compiles",
                  "registry first-calls at new shapes through the engine",
                  fn=lambda: st.compiles)
        register_compile_metrics(reg)

    def metrics_snapshot(self) -> dict:
        """JSON-ready dict of every registered metric, evaluated now."""
        return self.metrics.snapshot()

    def metrics_prometheus(self) -> str:
        """One Prometheus text-exposition scrape page."""
        return self.metrics.to_prometheus()

    # -- admission ----------------------------------------------------------

    def submit(self, inst: MulticutInstance, route: Route | None = None,
               deadline_s: float | None = None) -> SolveTicket:
        """Admit one request. ``route`` pins the routing decision (else
        the engine routes — statically by size, or by measured wall EMAs
        under ``adaptive_routing``); ``deadline_s`` is a relative
        completion deadline driving early partial flushes (and miss
        accounting — the engine never drops a late request). Bucketing
        may reject instances over the policy caps with ``ValueError``."""
        inst = inst.to(self.device)
        bucket = self.policy.bucket_of(inst)
        if route is None:
            if self.adaptive_routing:
                route = self.router.route_adaptive(
                    inst.num_nodes, inst.num_edges, bucket, self.stats,
                    traffic="solve", min_samples=self.min_route_samples)
            else:
                route = self.router.route_instance(inst)
        route = self._resolve_route(bucket, route, inst)
        self._check_batch_split(route)
        now = self._clock()
        deadline = None if deadline_s is None else now + deadline_s
        ticket = SolveTicket(self, inst, bucket, route, now,
                             deadline=deadline, req_id=next(self._req_ids))
        self._queues.setdefault((bucket, route), deque()).append(ticket)
        self.stats.n_submitted += 1
        if deadline is not None:
            self.stats.n_deadlined += 1
        if self.tracer is not None:
            self.tracer.record_instant(
                "admit", now, tid=ticket.req_id, nodes=bucket.nodes,
                edges=bucket.edges, mode=route.mode, backend=route.backend,
                deadline_s=deadline_s)
        self.pump()                     # full queues dispatch immediately
        return ticket

    def submit_many(self, instances) -> list[SolveTicket]:
        return [self.submit(i) for i in instances]

    # -- sticky delta sessions ---------------------------------------------

    def open_session(self, inst: MulticutInstance,
                     route: Route | None = None,
                     session_id: str | None = None,
                     warm: bool = True) -> DeltaSession:
        """Open a sticky incremental session: route the instance as
        *delta* traffic, lift it onto its bucket, run the cold solve, and
        pin (bucket, route, warm) for every later tick. The returned
        session's ``last_result`` holds the padding-stripped cold result;
        feed patches to :meth:`submit_delta`.

        The cold open dispatches immediately (sessions are expected to be
        long-lived — amortising the open across a batch would couple
        unrelated sessions' start-up latencies). With ``max_sessions``
        set, the least-recently-used session is settled and evicted
        first when the store is full."""
        inst = inst.to(self.device)
        if route is None:
            route = self.router.route_instance(inst, traffic="delta")
        bucket = self.policy.bucket_of(inst)
        route = self._resolve_route(bucket, route, inst)
        if warm and route.mode == "d":
            raise ValueError("warm delta sessions need a primal solution "
                             "to lift; mode 'd' produces none")
        if self.max_sessions is not None:
            while len(self.sessions) >= self.max_sessions:
                victim = self.sessions.lru()
                self._settle_session(victim)
                self.sessions.close(victim.session_id)
                self.stats.n_sessions_evicted += 1
                if self.tracer is not None:
                    self.tracer.record_instant(
                        "session_evict", self._clock(),
                        session=victim.session_id)
        t_open = self._clock() if self.tracer is not None else 0.0
        padded = pad_instance(inst, bucket)
        traces0 = api.trace_count()
        res, state = api.solve_with_state(padded, mode=route.mode,
                                          config=route.config,
                                          backend=route.backend,
                                          device=self.device)
        api.block_until_ready(res)
        self.stats.compiles += api.trace_count() - traces0
        sid = (session_id if session_id is not None
               else self.sessions.allocate_id())
        session = DeltaSession(
            session_id=sid, state=state, bucket=bucket, route=route,
            warm=warm, num_nodes=inst.num_nodes, patch_cap=self.patch_cap,
            last_result=strip_result(res, inst.num_nodes))
        self.sessions.add(session)
        self.stats.n_sessions_opened += 1
        if self.tracer is not None:
            self.tracer.record_span("session_open", t_open, self._clock(),
                                    session=sid, mode=route.mode)
        return session

    def submit_delta(self, session_id: str, patch: DeltaPatch,
                     deadline_s: float | None = None) -> DeltaTicket:
        """Queue one delta tick against a session. Ticks from *different*
        sessions in the same (bucket, route, warm) micro-batch together
        and overlap in flight; ticks of the *same* session are serialised
        — an unsettled previous tick is dispatched and harvested first,
        because this tick's patch applies to the state it produces."""
        session = self.sessions.get(session_id)
        self._settle_session(session)
        patch = pad_patch(patch.to(self.device), self.patch_cap)
        now = self._clock()
        deadline = None if deadline_s is None else now + deadline_s
        ticket = DeltaTicket(self, session, patch, now, deadline=deadline,
                             req_id=next(self._req_ids))
        session.pending = ticket
        self._delta_queues.setdefault(session.key, deque()).append(ticket)
        self.stats.n_delta_submitted += 1
        if deadline is not None:
            self.stats.n_deadlined += 1
        if self.tracer is not None:
            self.tracer.record_instant(
                "admit", now, tid=ticket.req_id, kind="delta",
                session=session.session_id, deadline_s=deadline_s)
        self.pump()
        return ticket

    def close_session(self, session_id: str) -> DeltaSession:
        """Settle any in-flight tick, then drop the session (its carried
        tensors become collectable)."""
        session = self.sessions.get(session_id)
        self._settle_session(session)
        return self.sessions.close(session_id)

    def _settle_session(self, session: DeltaSession) -> None:
        """Bring a session fully up to date: dispatch its queued tick (if
        any) and harvest it out of the in-flight window, so
        ``session.state`` reflects every submitted patch."""
        t = session.pending
        if t is not None and not t.done:
            self.flush_deltas(session.key)
            self._drain_ticket(t)

    def _check_batch_split(self, route: Route) -> None:
        """Admission/warmup guard: the dispatch batch axis must split
        evenly across the route's (clamped) device shards — fail here with
        a clear error rather than at dispatch."""
        shards = resolve_batch_shards(route.batch_shards)
        if self.batch_cap % shards:
            raise ValueError(
                f"batch_cap={self.batch_cap} is not divisible by the "
                f"route's {shards} batch shard(s); the dispatch batch "
                f"axis must split evenly across devices")

    # -- routing refinement -------------------------------------------------

    def _resolve_route(self, bucket: Bucket, route: Route,
                       inst: MulticutInstance | None) -> Route:
        """Per-(bucket, route) ``sparse_row_cap_short`` self-tuning:
        sparse-resolved routes get a cap calibrated to the p95 of the
        first seen instance's attractive-degree histogram (clamped to
        ``[ROW_CAP_FLOOR, sparse_row_cap]``), cached so every later
        request on the bucket reuses the same tuned registry entry. The
        covering caps in the degree-bucketed separation make any value
        bit-identical — this tunes wall-clock only. Dense routes, direct
        ``api.solve`` callers, and engines with ``tune_short_cap=False``
        keep the static default."""
        if not self.tune_short_cap:
            return route
        impl = resolve_graph_impl(route.config.graph_impl, bucket.nodes,
                                  route.config.sparse_threshold)
        if impl != "sparse":
            return route
        cache_key = (bucket, route)
        tuned = self._tuned_routes.get(cache_key)
        if tuned is None:
            if inst is None:        # shape-only warmup: pin the static cap
                tuned = route
            else:
                cap = self._p95_attractive_degree(inst, route)
                tuned = dataclasses.replace(route, config=dataclasses.replace(
                    route.config, sparse_row_cap_short=cap))
            self._tuned_routes[cache_key] = tuned
            self._static_route[tuned] = route
        return tuned

    @staticmethod
    def _p95_attractive_degree(inst: MulticutInstance, route: Route) -> int:
        """p95 of the per-node attractive (cost > 0) degree over valid
        nodes — the short-row cap that covers ~95% of CSR rows in the
        cheap separation bucket. Delegates to the shared
        :func:`repro_torch.core.graph.attractive_degree_p95` (also behind
        ``api.solve(tune_sparse_caps=True)``)."""
        return attractive_degree_p95(inst, ROW_CAP_FLOOR,
                                     route.config.sparse_row_cap)

    def _ladder(self, route: Route) -> tuple[int, ...]:
        rungs = self._ladders.get(route)
        if rungs is None:
            rungs = batch_ladder(self.batch_cap,
                                 resolve_batch_shards(route.batch_shards))
            self._ladders[route] = rungs
        return rungs

    # -- batching / dispatch ------------------------------------------------

    def pump(self, force: bool = False) -> int:
        """One scheduling step: harvest completed in-flight dispatches,
        then dispatch every full batch plus partial batches whose head
        request has waited past ``flush_timeout_s`` or whose earliest
        deadline is under pressure (now + the route's EMA wall would
        overshoot it) — tightest-deadline queues first — then harvest
        again. ``force`` flushes every non-empty queue. Returns the
        number of dispatches issued."""
        self._harvest()
        n = 0
        for key, q in self._ordered(self._queues):
            while len(q) >= self.batch_cap:
                self._dispatch(key, [q.popleft()
                                     for _ in range(self.batch_cap)],
                               self.batch_cap)
                n += 1
            # re-read the clock per queue: a blocking (window-full)
            # dispatch above may have pushed later queues' heads past
            # their timeout or deadline margin
            now = self._clock()
            if q:
                reason = self._flush_reason(key, q, now, force)
                if reason is not None:
                    if self.tracer is not None:
                        self.tracer.record_instant(
                            "flush", now, reason=reason, queued=len(q),
                            nodes=key[0].nodes, mode=key[1].mode)
                    n += self._flush_solve_queue(key, q)
        for key, q in self._ordered(self._delta_queues):
            while len(q) >= self.batch_cap:
                self._dispatch_delta(key, [q.popleft()
                                           for _ in range(self.batch_cap)])
                n += 1
            now = self._clock()
            if q:
                reason = self._flush_reason(key, q, now, force)
                if reason is not None:
                    if self.tracer is not None:
                        self.tracer.record_instant(
                            "flush", now, reason=reason, queued=len(q),
                            kind="delta")
                    while q:
                        self._dispatch_delta(
                            key,
                            [q.popleft()
                             for _ in range(min(len(q), self.batch_cap))])
                        n += 1
        self._harvest()
        return n

    def _flush_reason(self, key, q, now: float,
                      force: bool) -> str | None:
        """Why a non-empty partial queue should flush now — "force",
        "timeout", or "deadline" — or None to keep batching. Evaluation
        order matches the old boolean predicate, so flush behaviour is
        unchanged; the reason string only feeds the tracer."""
        if force:
            return "force"
        if self._timed_out(q, now):
            return "timeout"
        if self._deadline_pressure(key, q, now):
            return "deadline"
        return None

    @staticmethod
    def _ordered(queues: dict):
        """Queues sorted by their earliest queued deadline (deadline-free
        queues last, in insertion order) — the flush order under load."""
        def earliest(q):
            ds = [t.deadline for t in q if t.deadline is not None]
            return min(ds) if ds else math.inf
        return sorted(queues.items(), key=lambda kv: earliest(kv[1]))

    def _timed_out(self, q, now: float) -> bool:
        return (self.flush_timeout_s is not None
                and now - q[0].t_submit >= self.flush_timeout_s)

    def _deadline_pressure(self, key, q, now: float) -> bool:
        """True when waiting any longer risks missing the earliest queued
        deadline: the route's expected wall (EMA; ``flush_timeout_s`` as
        a cold fallback) no longer fits before it."""
        ds = [t.deadline for t in q if t.deadline is not None]
        if not ds:
            return False
        est = self.stats.wall_ema(self._ema_key(key))
        if est is None:
            est = self.flush_timeout_s or 0.0
        return now + est >= min(ds)

    def _ema_key(self, key):
        """Queue key → wall-EMA key: tuned routes record under their
        static parent so adaptive routing compares like to like."""
        bucket, route = key[0], key[1]
        return (bucket, self._static_route.get(route, route), *key[2:])

    def flush(self, key: tuple[Bucket, Route] | None = None) -> int:
        """Force-dispatch pending requests — one queue (``key``) or all of
        them — regardless of occupancy, timeout, or deadline margin."""
        if key is None:
            return self.pump(force=True)
        q = self._queues.get(key)
        if not q:
            return 0
        n = 0
        while len(q) >= self.batch_cap:
            self._dispatch(key, [q.popleft()
                                 for _ in range(self.batch_cap)],
                           self.batch_cap)
            n += 1
        if q:
            n += self._flush_solve_queue(key, q)
        return n

    def _flush_solve_queue(self, key, q) -> int:
        """Dispatch a partial queue over the sub-batch ladder: greedy
        power-of-two chunks instead of one batch_cap-padded dispatch."""
        _, route = key
        n = 0
        for take, size in decompose_batch(len(q), self._ladder(route)):
            self._dispatch(key, [q.popleft() for _ in range(take)], size)
            n += 1
        return n

    def flush_deltas(self, key: tuple[Bucket, Route, bool] | None = None
                     ) -> int:
        """Force-dispatch pending delta ticks — one session key or all."""
        if key is None:
            n = 0
            for k in list(self._delta_queues):
                n += self.flush_deltas(k)
            return n
        q = self._delta_queues.get(key)
        if not q:
            return 0
        n = 0
        while q:
            take = [q.popleft() for _ in range(min(len(q), self.batch_cap))]
            self._dispatch_delta(key, take)
            n += 1
        return n

    def _dispatch(self, key: tuple[Bucket, Route],
                  tickets: list[SolveTicket], size: int) -> None:
        bucket, route = key
        batch = pad_batch([t.inst for t in tickets], bucket, size)
        fn = api.compiled_solve(mode=route.mode, config=route.config,
                                backend=route.backend, batched=True,
                                batch_shards=route.batch_shards)
        traces0 = api.trace_count()
        res = fn(batch)
        self.stats.compiles += api.trace_count() - traces0
        self.stats.n_dispatches += 1
        t_disp = self._clock()
        if self.tracer is not None:
            self.tracer.record_instant(
                "dispatch", t_disp, kind="solve", nodes=bucket.nodes,
                mode=route.mode, backend=route.backend,
                n_tickets=len(tickets), n_slots=size)
        self._push(_InFlight(kind="solve", key=key,
                             ema_key=self._ema_key(key), tickets=tickets,
                             res=res, states2=None,
                             t_dispatch=t_disp, n_slots=size),
                   route.backend)

    def _filler_state(self, bucket: Bucket):
        """Per-bucket cached filler: a fresh DeltaState around the
        all-invalid filler instance. Batch tails dispatch against it (an
        empty patch on an empty graph — structurally neutral, like the
        solve path's filler instances)."""
        st = self._filler_states.get(bucket)
        if st is None:
            st = init_delta_state(filler_instance(bucket, self.device))
            self._filler_states[bucket] = st
        return st

    def _dispatch_delta(self, key: tuple[Bucket, Route, bool],
                        tickets: list[DeltaTicket]) -> None:
        bucket, route, warm = key
        n_fill = self.batch_cap - len(tickets)
        states = [t.session.state for t in tickets] \
            + [self._filler_state(bucket)] * n_fill
        patches = [t.patch for t in tickets] \
            + [make_patch(bucket.nodes, pad_entries=self.patch_cap,
                          device=self.device)] * n_fill
        sbatch = tree_map(lambda *xs: torch.stack(xs), *states)
        pbatch = tree_map(lambda *xs: torch.stack(xs), *patches)
        fn = api.compiled_delta(mode=route.mode, config=route.config,
                                backend=route.backend, warm=warm,
                                batched=True)
        traces0 = api.trace_count()
        res, states2, _info = fn(sbatch, pbatch)
        self.stats.compiles += api.trace_count() - traces0
        self.stats.n_delta_dispatches += 1
        t_disp = self._clock()
        if self.tracer is not None:
            self.tracer.record_instant(
                "dispatch", t_disp, kind="delta", nodes=bucket.nodes,
                mode=route.mode, backend=route.backend,
                n_tickets=len(tickets), n_slots=self.batch_cap)
        self._push(_InFlight(kind="delta", key=key,
                             ema_key=self._ema_key(key), tickets=tickets,
                             res=res, states2=states2,
                             t_dispatch=t_disp,
                             n_slots=self.batch_cap),
                   route.backend)

    # -- in-flight window ---------------------------------------------------

    def _push(self, entry: _InFlight, backend: str) -> None:
        """Park a dispatch on its backend's in-flight window. A full
        window back-pressures by harvesting (blocking on) the *oldest*
        entry only — the one most likely already done — so dispatch keeps
        overlapping with device execution. ``max_inflight=0`` finalises
        immediately: the synchronous engine."""
        dq = self._inflight.setdefault(backend, deque())
        dq.append(entry)
        while len(dq) > self.max_inflight:
            self._finalize(dq.popleft())
        total = sum(len(d) for d in self._inflight.values())
        self.stats.inflight_high_water = max(
            self.stats.inflight_high_water, total)

    def _harvest(self) -> int:
        """Finalise every in-flight dispatch whose results are ready,
        oldest-first per backend, without blocking on any that are not.
        Returns the number harvested."""
        n = 0
        for dq in self._inflight.values():
            while dq and self._ready(dq[0].res):
                self._finalize(dq.popleft())
                n += 1
        return n

    def drain(self) -> int:
        """Blocking harvest of the whole in-flight window: after this,
        every dispatched request's ticket is resolved."""
        n = 0
        for dq in self._inflight.values():
            while dq:
                self._finalize(dq.popleft())
                n += 1
        return n

    def _drain_ticket(self, ticket) -> None:
        """Finalise in-flight entries (oldest-first per backend) until
        the given ticket resolves. The ticket must already have been
        dispatched (its queue flushed)."""
        for dq in self._inflight.values():
            while dq and not ticket.done:
                self._finalize(dq.popleft())
            if ticket.done:
                return

    def _finalize(self, entry: _InFlight) -> None:
        """Demux one dispatch: wait until its results are computed (a
        no-op when harvested ready), strip and hand each ticket its
        result, write delta states back to their sessions, and fold the
        measured wall into the route's EMAs and deadline counters."""
        t_wait = self._clock() if self.tracer is not None else 0.0
        api.block_until_ready(entry.res)
        now = self._clock()
        self.stats.record_wall(entry.ema_key, now - entry.t_dispatch,
                               entry.n_slots)
        if entry.kind == "solve":
            for b, t in enumerate(entry.tickets):
                single = tree_map(lambda x, b=b: x[b], entry.res)
                t._result = strip_result(single, t.inst.num_nodes)
                t.t_done = now
                self._account_latency(t, now)
            self.stats.n_completed += len(entry.tickets)
            self.stats.n_filler_slots += entry.n_slots - len(entry.tickets)
        else:
            for b, t in enumerate(entry.tickets):
                t.session.state = tree_map(lambda x, b=b: x[b],
                                           entry.states2)
                single = tree_map(lambda x, b=b: x[b], entry.res)
                t._result = strip_result(single, t.session.num_nodes)
                t.session.last_result = t._result
                t.session.n_ticks += 1
                if t.session.pending is t:
                    t.session.pending = None
                t.t_done = now
                self._account_latency(t, now)
            self.stats.n_delta_completed += len(entry.tickets)
            self.stats.n_delta_filler_slots += (entry.n_slots
                                                - len(entry.tickets))
        if self.tracer is not None:
            t_end = self._clock()
            for t in entry.tickets:
                # one swimlane per request: queued → solve (in flight)
                self.tracer.record_span("queued", t.t_submit,
                                        entry.t_dispatch, tid=t.req_id)
                self.tracer.record_span("solve", entry.t_dispatch, now,
                                        tid=t.req_id, kind=entry.kind)
            self.tracer.record_span("harvest", t_wait, now,
                                    kind=entry.kind,
                                    n_slots=entry.n_slots)
            self.tracer.record_span("demux", now, t_end,
                                    kind=entry.kind,
                                    n_tickets=len(entry.tickets))

    def _account_latency(self, ticket, now: float) -> None:
        self.stats.latency_hist.observe(now - ticket.t_submit)
        if ticket.deadline is not None and now > ticket.deadline:
            self.stats.n_deadline_missed += 1
            if self.tracer is not None:
                self.tracer.record_instant(
                    "deadline_miss", now, tid=ticket.req_id,
                    late_s=now - ticket.deadline)

    # -- lifecycle helpers --------------------------------------------------

    def warmup(self, examples, route: Route | None = None) -> int:
        """Pre-build the registry entries the given examples would hit: each
        example — a ``(num_nodes, num_edges)`` tuple or a full
        :class:`MulticutInstance` — is routed and bucketed exactly like a
        real request (``route`` pins the routing, e.g. to warm every
        candidate route for adaptive serving), then its registry entry runs
        once on an all-filler batch at *every* sub-batch ladder rung.
        Returns the number of fresh first-calls; requests landing in
        warmed (bucket, route)s never pay one.

        Instance examples additionally feed the ``sparse_row_cap_short``
        self-tuning, so the warmed entry is the tuned one; shape
        tuples pin the static cap for their (bucket, route) instead
        (there is no degree histogram to tune from)."""
        traces0 = api.trace_count()
        seen = set()
        for ex in examples:
            if isinstance(ex, MulticutInstance):
                inst, (num_nodes, num_edges) = ex.to(self.device), (
                    ex.num_nodes, ex.num_edges)
            else:
                inst, (num_nodes, num_edges) = None, ex
            bucket = self.policy.bucket_for(num_nodes, num_edges)
            r = (route if route is not None
                 else self.router.route(num_nodes, num_edges))
            r = self._resolve_route(bucket, r, inst)
            self._check_batch_split(r)
            if (bucket, r) in seen:
                continue
            seen.add((bucket, r))
            fn = api.compiled_solve(mode=r.mode, config=r.config,
                                    backend=r.backend, batched=True,
                                    batch_shards=r.batch_shards)
            for size in self._ladder(r):
                batch = pad_batch([filler_instance(bucket, self.device)],
                                  bucket, size)
                api.block_until_ready(fn(batch))
        fresh = api.trace_count() - traces0
        self.stats.compiles += fresh
        return fresh

    def calibration(self) -> dict:
        """Portable calibration snapshot: the measured per-(bucket, route)
        wall EMAs plus the tuned-route cache. Feed it to a fresh engine's
        :meth:`load_calibration` so adaptive routing, deadline margins,
        and row-cap tuning all start warm — what the sustained-load
        benchmark does between its calibration and timed engines."""
        return {
            "route_walls": {k: dataclasses.replace(v) for k, v in
                            self.stats.route_walls.items()},
            "tuned_routes": dict(self._tuned_routes),
            "static_route": dict(self._static_route),
        }

    def load_calibration(self, cal: dict) -> None:
        """Adopt another engine's :meth:`calibration` snapshot."""
        self.stats.route_walls.update(
            {k: dataclasses.replace(v) for k, v in
             cal["route_walls"].items()})
        self._tuned_routes.update(cal["tuned_routes"])
        self._static_route.update(cal["static_route"])

    def solve_stream(self, instances) -> list[SolveResult]:
        """Convenience driver: submit everything, flush, drain the
        in-flight window, and return results in submission order — the
        engine equivalent of mapping ``api.solve`` over the stream."""
        tickets = self.submit_many(instances)
        self.flush()
        self.drain()
        return [t.result() for t in tickets]

    @property
    def pending(self) -> int:
        """Requests queued but not yet dispatched."""
        return (sum(len(q) for q in self._queues.values())
                + sum(len(q) for q in self._delta_queues.values()))

    @property
    def inflight(self) -> int:
        """Dispatches issued but not yet harvested."""
        return sum(len(dq) for dq in self._inflight.values())

    def __repr__(self):
        return (f"SolveEngine(device={str(self.device)!r}, "
                f"batch_cap={self.batch_cap}, "
                f"flush_timeout_s={self.flush_timeout_s}, "
                f"max_inflight={self.max_inflight}, "
                f"queues={len(self._queues)}, pending={self.pending}, "
                f"inflight={self.inflight}, "
                f"served={self.stats.n_completed}, "
                f"sessions={len(self.sessions)}, "
                f"delta_served={self.stats.n_delta_completed}, "
                f"compiles={self.stats.compiles})")
