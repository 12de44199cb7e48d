"""Device-count policy of batched solves (port of the part of
``repro.core.dist`` the serving tier uses).

The reference shards a batch's leading axis over its device mesh. The
port runs on one card and does not shard yet: a requested count is
clamped to the cards present, and a clamped count above 1 raises.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_batch_shards"]


def resolve_batch_shards(shards: int | None) -> int:
    """Clamp a requested batch-shard count to the CUDA devices present (1
    on a host without one), so a router asking for 4 still serves on one
    card. A clamped count above 1 raises ``NotImplementedError``: the
    sharded batch is ROADMAP Queue 1 item 13."""
    if shards is None or shards <= 1:
        return 1
    n = min(int(shards), max(1, torch.cuda.device_count()))
    if n > 1:
        raise NotImplementedError(
            f"batch_shards={n} is not ported yet: a batch sharded over "
            f"{n} cards is ROADMAP Queue 1 item 13")
    return n
