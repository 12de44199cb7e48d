"""Local process groups: start ``world`` ranks of a ``python -c`` program
on this host and join them over a ``torch.distributed.FileStore``.

    outs = spawn(code, world=4, store=tmp / "store")    # in the parent
    with process_group("gloo") as (rank, world):        # in each rank
        ...

No TCP port is opened: the ranks rendezvous through the store file. The
parent passes each rank its number, the world size and the store's path
in the environment (``REPRO_RANK``, ``REPRO_WORLD``, ``REPRO_STORE``),
waits for every rank, and kills the rest when one fails or the time runs
out, so no process outlives the call.

A rank ends its group itself: :func:`process_group` meets the other ranks
at a barrier, destroys the default group (and with it every subgroup) and
then checks that no process-group object outlives it. A gloo group's
worker threads (``ProcessGroupGloo::runLoop``) free the tensors of
finished collectives, which takes the GIL; they are joined only when the
group object is freed. A group object still referenced at interpreter
exit leaves them running, and one that takes the GIL while the
interpreter finalises is ended by a forced unwind through C++ that aborts
the rank (SIGABRT, ``terminate called without an active exception``)
after its work is done. ``destroy_process_group`` alone does not free a
group that something else still holds: a cache of subgroups, or the
default arguments ``group=group.WORLD`` of
``torch.distributed.nn.functional``, which bind the default group if
that module is first imported while one exists (``torch._dynamo``
imports it, and the first op under a ``TorchDispatchMode``, such as the
roofline's work counter, imports ``torch._dynamo``). So
:func:`import_before_group` imports it before a group is made.
"""
from __future__ import annotations

import contextlib
import gc
import os
import signal
import subprocess
import sys
import time
import weakref
from pathlib import Path

__all__ = ["import_before_group", "process_group", "spawn"]


def _describe(rc) -> str:
    """A return code as text: a negative one names its signal."""
    if isinstance(rc, int) and rc < 0:
        try:
            return f"{rc}, {signal.Signals(-rc).name}"
        except ValueError:
            pass
    return str(rc)


def spawn(code: str, world: int, store, env: dict | None = None,
          timeout: float = 600.0) -> list[str]:
    """Run ``code`` as ``world`` ranks and return their standard outputs
    in rank order. Raises ``RuntimeError`` as soon as a rank exits nonzero
    or dies by a signal (the others are killed: they would wait on it
    forever) or the time runs out; the message names the first failing
    rank and its return code (a signal by name) and holds the tail of
    every rank's standard error. Each rank's output goes to a file beside
    the store."""
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
        tails = "\n".join(
            f"--- rank {r} ({_describe(p.returncode)}), stderr tail:\n"
            f"{t[1][-3000:]}" for r, (p, t) in enumerate(zip(procs, texts)))
        raise RuntimeError(f"rank {rank} of {world} failed "
                           f"({_describe(rc)}):\n{tails}")
    return [t[0] for t in texts]


def import_before_group() -> None:
    """Import the torch modules that bind the default process group at
    import time, while none exists, so that no later lazy import pins a
    group for the life of the process (see the module docstring). Call
    it before ``init_process_group``."""
    import torch.distributed.nn.functional  # noqa: F401


@contextlib.contextmanager
def process_group(backend: str = "gloo"):
    """Join the group :func:`spawn` started this rank in for the body of
    the ``with``; yields (rank, world size). When the body ends normally
    every rank meets at a barrier and then destroys the default group,
    which also destroys the subgroups made from it; then every group
    object must have been freed (its threads joined), or ``RuntimeError``
    names how many are still referenced: keep no group handle past the
    block. When the body raises, the group is destroyed without the
    barrier (the other ranks may never reach it) and the error
    propagates."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d
    rank = int(os.environ["REPRO_RANK"])
    world = int(os.environ["REPRO_WORLD"])
    store = dist.FileStore(os.environ["REPRO_STORE"], world)
    import_before_group()
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    ok = False
    try:
        yield rank, world
        ok = True
    finally:
        groups = [weakref.ref(g) for g in distributed_c10d._world.pg_map]
        try:
            if ok:
                dist.barrier()
        finally:
            dist.destroy_process_group()
    gc.collect()
    alive = sum(g() is not None for g in groups)
    if alive:
        raise RuntimeError(
            f"rank {rank}: {alive} of {len(groups)} process group(s) still "
            f"referenced after destroy_process_group; their worker threads "
            f"would outlive the interpreter")
