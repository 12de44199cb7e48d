"""Config-driven routing of solve requests across modes, configs and
backends (port of ``repro.serve.router``).

A :class:`Route` is everything the engine needs to pick a registry entry
for a request — (mode, SolverConfig, backend, batch_shards) — and a
:class:`Router` is an ordered rule list mapping instance *size* to a
Route: the serving analogue of ``SolverConfig.graph_impl="auto"``, lifted
to whole solver configurations. The default router sends small instances
to the dense (N, N) separation path and large ones to the sparse CSR path
with chunked separation; its crossover is the reference's
``DEFAULT_SPARSE_THRESHOLD`` (256 padded nodes), not yet measured on the
card.

**Backend — a deliberate difference from the reference.** A Route's
default backend is ``"cuda"`` (the port's kernels, as ``api``'s default),
where the reference's is ``"reference"``.

Routers are declarative and JSON-able: :meth:`Router.from_spec` builds
one from a plain dict (presets by name + config overrides).
"""
from __future__ import annotations

import dataclasses

from repro_torch.api import BACKENDS, DEFAULT_BACKEND, MODES, get_preset
from repro_torch.core.graph import DEFAULT_SPARSE_THRESHOLD, \
    MulticutInstance
from repro_torch.core.solver import SolverConfig

__all__ = ["Route", "RoutingRule", "Router", "TRAFFIC", "default_router"]


@dataclasses.dataclass(frozen=True)
class Route:
    """Where a request is sent: the registry key minus the bucket shape.
    Frozen + hashable — (bucket, route) keys the engine's queues and
    registry lookups."""
    mode: str = "pd"
    config: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    backend: str = DEFAULT_BACKEND
    batch_shards: int = 1

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; expected one "
                             f"of {MODES}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {BACKENDS}")
        if self.batch_shards < 1:
            raise ValueError(f"batch_shards must be >= 1, got "
                             f"{self.batch_shards}")
        if self.batch_shards > 1 and self.config.separation_shards > 1:
            raise ValueError("a route cannot both shard the batch axis and "
                             "the separation axis (one device mesh)")


TRAFFIC = ("any", "solve", "delta")


@dataclasses.dataclass(frozen=True)
class RoutingRule:
    """``route`` applies when the instance fits under both bounds
    (``None`` = unbounded on that axis) and the request's traffic class
    matches. Rules are tried in order; sizes are the instance's *padded*
    counts — the same numbers bucketing sees.

    ``traffic`` scopes the rule: "solve" (one-shot requests), "delta"
    (sticky-session incremental re-solves — see
    :mod:`repro_torch.serve.session`), or "any" (the default: both). Delta
    traffic typically wants a cheaper config (fewer rounds, smaller
    ``max_neg``) because warm re-solves only re-decide the patched
    neighbourhood.
    """
    route: Route
    max_nodes: int | None = None
    max_edges: int | None = None
    traffic: str = "any"

    def __post_init__(self):
        if self.traffic not in TRAFFIC:
            raise ValueError(f"unknown traffic class {self.traffic!r}; "
                             f"expected one of {TRAFFIC}")

    def matches(self, num_nodes: int, num_edges: int,
                traffic: str = "solve") -> bool:
        return ((self.traffic == "any" or self.traffic == traffic)
                and (self.max_nodes is None or num_nodes <= self.max_nodes)
                and (self.max_edges is None or num_edges <= self.max_edges))


class Router:
    """Ordered size-based routing rules with a catch-all default."""

    def __init__(self, rules: list[RoutingRule] = (),
                 default: Route | None = None):
        self.rules = tuple(rules)
        self.default = default if default is not None else Route()

    def route(self, num_nodes: int, num_edges: int,
              traffic: str = "solve") -> Route:
        if traffic not in TRAFFIC:
            raise ValueError(f"unknown traffic class {traffic!r}; "
                             f"expected one of {TRAFFIC}")
        for rule in self.rules:
            if rule.matches(num_nodes, num_edges, traffic):
                return rule.route
        return self.default

    def route_instance(self, inst: MulticutInstance,
                       traffic: str = "solve") -> Route:
        return self.route(inst.num_nodes, inst.num_edges, traffic)

    def routes(self) -> tuple[Route, ...]:
        """Every distinct Route this router can emit (rule order, default
        last) — e.g. for enumerating a deployment's registry entries."""
        out = []
        for r in (*(rule.route for rule in self.rules), self.default):
            if r not in out:
                out.append(r)
        return tuple(out)

    def candidates(self, traffic: str = "solve") -> tuple[Route, ...]:
        """Every distinct Route a request of this traffic class *could*
        take under some size — the adaptive router's choice set. Static
        rule order is preserved (default last)."""
        if traffic not in TRAFFIC:
            raise ValueError(f"unknown traffic class {traffic!r}; "
                             f"expected one of {TRAFFIC}")
        out = []
        for rule in self.rules:
            if (rule.traffic in ("any", traffic)
                    and rule.route not in out):
                out.append(rule.route)
        if self.default not in out:
            out.append(self.default)
        return tuple(out)

    def route_adaptive(self, num_nodes: int, num_edges: int, bucket,
                       stats, traffic: str = "solve",
                       min_samples: int = 3) -> Route:
        """Latency-adaptive routing: pick the candidate route with the
        lowest measured per-slot wall-clock EMA for this bucket
        (:meth:`repro_torch.serve.engine.EngineStats.slot_ema`). Falls
        back to
        the static size table (:meth:`route`) until *every* candidate has
        at least ``min_samples`` completed dispatches on the bucket —
        comparing a warm EMA against nothing would lock in whichever
        route happened to run first, so the engine instead keeps routing
        statically (exploring for free: static traffic itself warms the
        EMAs of whichever routes it exercises; a calibration pass warms
        the rest)."""
        static = self.route(num_nodes, num_edges, traffic)
        cands = self.candidates(traffic)
        if len(cands) < 2:
            return static
        emas = [stats.slot_ema((bucket, r), min_samples) for r in cands]
        if any(e is None for e in emas):
            return static
        return cands[min(range(len(cands)), key=lambda i: emas[i])]

    @classmethod
    def from_spec(cls, spec: dict) -> "Router":
        """Build a router from a JSON-able dict::

            Router.from_spec({
                "rules": [
                    {"max_nodes": 512, "preset": "paper-pd",
                     "config": {"graph_impl": "dense"}},
                    {"max_nodes": 65536, "preset": "pd-chunked",
                     "batch_shards": 4},
                ],
                "default": {"mode": "pd",
                            "config": {"graph_impl": "sparse"}},
            })

        Each rule/default entry gives either a ``preset`` name (its mode +
        config seed the route) or an explicit ``mode``; ``config`` is a
        dict of ``SolverConfig`` field overrides applied on top; ``backend``
        and ``batch_shards`` pass through. A rule may scope itself with
        ``"traffic": "solve" | "delta"`` ("any" when omitted).
        """
        def build_route(entry: dict) -> Route:
            entry = dict(entry)
            entry.pop("max_nodes", None)
            entry.pop("max_edges", None)
            entry.pop("traffic", None)
            preset = entry.pop("preset", None)
            mode = entry.pop("mode", None)
            overrides = entry.pop("config", {})
            backend = entry.pop("backend", DEFAULT_BACKEND)
            batch_shards = entry.pop("batch_shards", 1)
            if entry:
                raise ValueError(f"unknown route keys {sorted(entry)}")
            if preset is not None:
                p = get_preset(preset)
                mode = p.mode if mode is None else mode
                config = p.config
            else:
                config = SolverConfig()
            mode = "pd" if mode is None else mode
            if overrides:
                bad = set(overrides) - {f.name for f in
                                        dataclasses.fields(SolverConfig)}
                if bad:
                    raise ValueError(f"unknown SolverConfig fields "
                                     f"{sorted(bad)}")
                config = dataclasses.replace(config, **overrides)
            return Route(mode=mode, config=config, backend=backend,
                         batch_shards=batch_shards)

        bad = set(spec) - {"rules", "default"}
        if bad:
            raise ValueError(f"unknown router spec keys {sorted(bad)}; "
                             f"expected 'rules' and/or 'default'")
        rules = [RoutingRule(route=build_route(e),
                             max_nodes=e.get("max_nodes"),
                             max_edges=e.get("max_edges"),
                             traffic=e.get("traffic", "any"))
                 for e in spec.get("rules", ())]
        default = spec.get("default")
        return cls(rules=rules,
                   default=build_route(default) if default else None)


def default_router(batch_shards: int = 1,
                   dense_max_nodes: int = DEFAULT_SPARSE_THRESHOLD) -> Router:
    """The default table: dense separation up to ``dense_max_nodes`` padded
    nodes, sparse CSR with chunked separation above. The cutoff defaults
    to the crossover the solver's ``graph_impl="auto"`` uses
    (:data:`repro_torch.core.graph.DEFAULT_SPARSE_THRESHOLD`).
    ``batch_shards`` is clamped to the cards present at dispatch."""
    small = Route(mode="pd",
                  config=SolverConfig(graph_impl="dense"),
                  batch_shards=batch_shards)
    large = Route(mode="pd",
                  config=SolverConfig(graph_impl="sparse",
                                      separation_chunk=64),
                  batch_shards=batch_shards)
    return Router(
        rules=[RoutingRule(route=small, max_nodes=dense_max_nodes)],
        default=large)
