"""Local process groups: start ``world`` ranks of a ``python -c`` program
on this host and join them over a ``torch.distributed.FileStore``.

    outs = spawn(code, world=4, store=tmp / "store")    # in the parent
    rank, world = init_process_group("gloo")            # in each rank

No TCP port is opened: the ranks rendezvous through the store file. The
parent passes each rank its number, the world size and the store's path
in the environment (``REPRO_RANK``, ``REPRO_WORLD``, ``REPRO_STORE``),
waits for every rank, and kills the rest when one fails or the time runs
out, so no process outlives the call.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["init_process_group", "spawn"]


def spawn(code: str, world: int, store, env: dict | None = None,
          timeout: float = 600.0) -> list[str]:
    """Run ``code`` as ``world`` ranks and return their standard outputs
    in rank order. Raises ``RuntimeError`` with the failing rank's
    standard error as soon as a rank exits nonzero (the others are
    killed: they would wait on it forever) or the time runs out. Each
    rank's output goes to a file beside the store."""
    store = Path(store)
    store.unlink(missing_ok=True)
    base = dict(os.environ if env is None else env)
    procs, logs = [], []
    for rank in range(world):
        e = dict(base, REPRO_RANK=str(rank), REPRO_WORLD=str(world),
                 REPRO_STORE=str(store))
        out = open(f"{store}.rank{rank}.out", "w+")
        err = open(f"{store}.rank{rank}.err", "w+")
        logs.append((out, err))
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=e,
                                      text=True, stdout=out, stderr=err))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = (bad[0], procs[bad[0]].returncode)
            elif time.monotonic() > deadline:
                failed = (None, "timeout")
            else:
                time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = (bad[0], procs[bad[0]].returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    if failed is not None:
        rank, rc = failed
        err = texts[rank][1] if rank is not None else \
            "\n".join(t[1][-1000:] for t in texts)
        raise RuntimeError(f"rank {rank} of {world} failed ({rc}):\n"
                           f"{err[-4000:]}")
    return [t[0] for t in texts]


def init_process_group(backend: str = "gloo") -> tuple[int, int]:
    """Join the group :func:`spawn` started this rank in; returns (rank,
    world size)."""
    import torch.distributed as dist
    rank = int(os.environ["REPRO_RANK"])
    world = int(os.environ["REPRO_WORLD"])
    store = dist.FileStore(os.environ["REPRO_STORE"], world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    return rank, world
