"""End-to-end distributed multicut: the paper's stated future work
("multi-GPU ... decomposition methods") over ``torch.distributed``; the
port of ``examples/distributed_multicut.py``.

    PYTHONPATH=src python -m repro_torch.examples.distributed_multicut \\
        [--device cpu] [--world 1|2|4|8]

Pipeline (the production path of ``repro_torch.core.dist``):
  1. the host partitioner splits a 4000-node instance into 8 blocks of
     512 nodes;
  2. every rank runs interior RAMA PD rounds on its 8/world blocks
     (separation → message passing → contraction, all rank-local);
  3. the block bounds and the boundary relaxation add up to a VALID
     global lower bound;
  4. the contracted blocks + boundary edges form a quotient instance,
     solved on one device;
  5. the composed labeling is scored on the original instance.

``--world 1`` runs every block in this process with no process group (or
on the group passed to :func:`main`); a larger world starts that many
ranks on this host with ``repro_torch.launch.ranks.spawn``, joined over
gloo (NCCL refuses two ranks on one card), each on ``--device``; the
quotient and the reference solve run in this process.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.dist import (
    make_dist_pd_round, merge_blocks_quotient, partition_instance,
)
from repro_torch.core.graph import random_instance, resolve_device

N_NODES = 4000
N_BLOCKS = 8
BLK_NODES = 512
BLK_EDGES = 8192
PAD_EDGES = 65536
KEYS = ("u", "v", "cost", "edge_valid", "node_valid", "boundary_cost")
SOLVE = api.SolverConfig(max_neg=1024, mp_iters=8)

# one rank of a spawned world: its blocks' round, the gathered mapping and
# bound written beside the store
RANK = """
import numpy as np
import torch.distributed as dist
from repro_torch.examples import distributed_multicut as ex
from repro_torch.launch.ranks import process_group
with process_group("gloo") as (rank, world):
    mapping, lb = ex.blocks_round(ex.partition(%(device)r), dist.group.WORLD,
                                  %(device)r)
np.savez(%(out)r + f".rank{rank}.npz", mapping=mapping, lb=lb)
"""


def instance(device):
    return random_instance(N_NODES, 0.004, seed=0, pad_edges=PAD_EDGES,
                           pad_nodes=N_BLOCKS * BLK_NODES, device=device)


def partition(device) -> dict:
    return partition_instance(instance(device), N_BLOCKS, BLK_NODES,
                              BLK_EDGES)


def blocks_round(parts: dict, group, device) -> tuple[np.ndarray, float]:
    """This rank's share of the distributed PD round over ``group``:
    every rank returns the mapping of all blocks and the global bound."""
    rnd = make_dist_pd_round(group, mp_iters=5, max_neg=256)
    out = rnd(*(torch.from_numpy(parts[k]).to(device) for k in KEYS))
    return out[5].cpu().numpy(), float(out[6])


def spawned_round(world: int, device) -> tuple[np.ndarray, float]:
    """The round over ``world`` spawned gloo ranks; every rank must
    return the same mapping and bound."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    from repro_torch.launch.ranks import spawn
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "round")
        spawn(RANK % dict(device=str(device), out=out), world=world,
              store=os.path.join(d, "store"), env=env)
        runs = [np.load(f"{out}.rank{r}.npz") for r in range(world)]
        mapping, lb = runs[0]["mapping"], float(runs[0]["lb"])
        for r, run in enumerate(runs):
            if not (np.array_equal(run["mapping"], mapping)
                    and float(run["lb"]) == lb):
                raise RuntimeError(f"rank {r} returned another round than "
                                   f"rank 0")
    return mapping, lb


def main(argv=None, group=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=1, choices=(1, 2, 4, 8))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if group is not None and args.world != 1:
        raise ValueError("a process group is used at --world 1 only")
    print(f"ranks: {args.world} ({N_BLOCKS // args.world} blocks each)")

    inst = instance(dev)
    parts = partition_instance(inst, N_BLOCKS, BLK_NODES, BLK_EDGES)
    n_boundary = len(parts["boundary_cost"])
    print(f"instance: {N_NODES} nodes, partitioned into {N_BLOCKS} blocks, "
          f"{n_boundary} boundary edges")

    if args.world == 1:
        mapping, lb = blocks_round(parts, group, dev)
    else:
        mapping, lb = spawned_round(args.world, dev)
    print(f"distributed round done; valid global LB = {lb:.2f}")

    # merge: quotient graph over contracted block clusters + boundary edges
    q, global_labels = merge_blocks_quotient(
        mapping, parts["boundary_u"], parts["boundary_v"],
        parts["boundary_cost"], BLK_NODES, pad_edges=PAD_EDGES, device=dev)
    nq = int(q.node_valid.sum())
    print(f"quotient instance: {nq} super-nodes")
    res_q = api.solve(q, mode="pd", config=SOLVE, device=dev)

    # compose: original node -> block cluster -> quotient cluster
    final = res_q.labels.cpu().numpy()[global_labels][:N_NODES]
    labels = np.concatenate([final, np.zeros(inst.num_nodes - N_NODES,
                                             np.int32)])
    obj = float(inst.objective(torch.from_numpy(labels).to(dev)))
    # single-device reference
    ref = api.solve(inst, mode="pd", config=SOLVE, device=dev)
    print(f"distributed objective {obj:.2f}   "
          f"single-device PD {float(ref.objective):.2f}   LB {lb:.2f}")
    assert lb <= obj + 1e-3, "LB must bound any feasible solution"
    print("OK: LB <= distributed objective (certificate holds)")
    return dict(world=args.world, lower_bound=lb, mapping=mapping,
                labels=final, objective=obj, quotient_nodes=nq,
                single_device_objective=float(ref.objective),
                single_device_result=ref)


if __name__ == "__main__":
    main()
