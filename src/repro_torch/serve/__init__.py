"""repro_torch.serve — bucketed, micro-batching serving for multicut (port
of ``repro.serve``).

The front end over :mod:`repro_torch.api`'s registry:

* :mod:`.buckets` — geometric size bucketing + neutral shape padding (one
  registry entry per bucket serves every instance in it);
* :mod:`.router` — declarative (size, traffic) → (mode, config, backend,
  batch_shards) routing;
* :mod:`.session` — sticky sessions carrying a
  :class:`repro_torch.incremental.DeltaState` between update ticks;
* :mod:`.engine` — the queueing / micro-batching / demux engine, with
  deadline-driven partial flushes over a power-of-two sub-batch ladder,
  an in-flight window harvested on CUDA events, latency-adaptive routing,
  metrics and request spans.

Quickstart::

    from repro_torch.serve import SolveEngine

    engine = SolveEngine(batch_cap=8)            # device="cuda"
    results = engine.solve_stream(instances)     # mixed sizes welcome

    session = engine.open_session(inst)          # sticky delta session
    ticket = engine.submit_delta(session.session_id, patch)
    res = ticket.result()                        # warm re-solve
"""
from repro_torch.serve.buckets import (
    Bucket, BucketPolicy, batch_ladder, decompose_batch, filler_instance,
    pad_batch, pad_instance, strip_result,
)
from repro_torch.serve.engine import (
    DeltaTicket, EngineStats, RouteWall, SolveEngine, SolveTicket,
)
from repro_torch.serve.router import (
    Route, Router, RoutingRule, TRAFFIC, default_router,
)
from repro_torch.serve.session import DeltaSession, SessionStore

__all__ = [
    "Bucket", "BucketPolicy", "DeltaSession", "DeltaTicket", "EngineStats",
    "Route", "RouteWall", "Router", "RoutingRule", "SessionStore",
    "SolveEngine", "SolveTicket", "TRAFFIC", "batch_ladder",
    "decompose_batch", "default_router", "filler_instance", "pad_batch",
    "pad_instance", "strip_result",
]
