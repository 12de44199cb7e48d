"""Sticky delta sessions: the serving-side handle around a carried
:class:`repro_torch.incremental.DeltaState` (port of
``repro.serve.session``).

A delta request is sticky: its patch only means something against the
session's carried state, and the updated state must flow back to exactly
that session. :class:`DeltaSession` pins the decisions made at open time
(bucket shape, route, warm/exact) so every later tick hits the same
registry entry, and carries the state the engine's batched delta dispatch
reads and writes.

Sessions are data + a registry: all scheduling lives in the engine, which
also serialises ticks *per session* — a session's next patch is never
batched with its previous one — while patches from different sessions in
the same (bucket, route) batch together.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

from repro_torch.core.solver import SolveResult
from repro_torch.incremental.state import DeltaState
from repro_torch.serve.buckets import Bucket
from repro_torch.serve.router import Route

__all__ = ["DeltaSession", "SessionStore"]


@dataclasses.dataclass
class DeltaSession:
    """One sticky incremental-solve session (mutable: the engine writes
    ``state`` back after every dispatched tick)."""
    session_id: str
    state: DeltaState           # carried at the BUCKET shape
    bucket: Bucket              # pinned at open: the compiled shape
    route: Route                # pinned at open: the registry settings
    warm: bool                  # pinned at open: warm vs exact re-solve
    num_nodes: int              # the request's own padded node count —
                                # what strip_result trims labels back to
    patch_cap: int              # static patch capacity P of every tick
    last_result: Optional[SolveResult] = None
    n_ticks: int = 0            # delta ticks completed (cold open excluded)
    pending: Optional[object] = None    # in-flight DeltaTicket, or None —
                                # the engine's per-session serialisation
                                # latch

    @property
    def key(self):
        """The queue/registry key this session's ticks dispatch under."""
        return (self.bucket, self.route, self.warm)


class SessionStore:
    """Engine-owned registry of live sessions (id allocation + lookup).

    Kept in recency order: :meth:`get` and :meth:`touch` move a session to
    the most-recently-used end, so :meth:`lru` is always the session idle
    the longest — the engine's eviction candidate when ``max_sessions`` is
    exceeded (each open session carries a full DeltaState on the device,
    so the store is the serving tier's resident-memory knob)."""

    def __init__(self):
        self._sessions: collections.OrderedDict[str, DeltaSession] = \
            collections.OrderedDict()
        self._next = 0

    def allocate_id(self) -> str:
        sid = f"s{self._next}"
        self._next += 1
        return sid

    def add(self, session: DeltaSession) -> DeltaSession:
        if session.session_id in self._sessions:
            raise ValueError(f"session {session.session_id!r} already open")
        self._sessions[session.session_id] = session
        return session

    def get(self, session_id: str) -> DeltaSession:
        try:
            sess = self._sessions[session_id]
        except KeyError:
            raise KeyError(f"unknown session {session_id!r}; open: "
                           f"{sorted(self._sessions)}") from None
        self._sessions.move_to_end(session_id)
        return sess

    def touch(self, session_id: str) -> None:
        """Mark a session recently used without fetching it."""
        self._sessions.move_to_end(session_id)

    def lru(self) -> Optional[DeltaSession]:
        """The least-recently-used open session (None when empty)."""
        return next(iter(self._sessions.values()), None)

    def close(self, session_id: str) -> DeltaSession:
        return self._sessions.pop(self.get(session_id).session_id)

    def __len__(self) -> int:
        return len(self._sessions)

    def __contains__(self, session_id: str) -> bool:
        return session_id in self._sessions

    def __iter__(self):
        return iter(self._sessions.values())
