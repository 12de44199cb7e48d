"""GNN → affinities → RAMA: the paper's deep-pipeline use-case (§1: "when
multicut is used in end-to-end training", instance segmentation); the port
of ``examples/gnn_multicut.py``.

    PYTHONPATH=src python -m repro_torch.examples.gnn_multicut [--device cpu]

1. A small EGNN is trained to predict same-cluster affinities on synthetic
   point clouds with planted clusters (edge label = same cluster).
2. Predicted logits become signed multicut edge costs (log-odds).
3. RAMA PD clusters the graph; we report the pairwise agreement with the
   planted clustering vs. simply thresholding the GNN's edges and taking
   connected components — what the combinatorial solver adds on top of the
   learned model (cycle-consistent decisions instead of independent edge
   cuts).

The point clouds come from CPU ``torch.Generator``s (other draws than the
JAX example's ``jax.random`` ones); the connected components of the
baseline come from ``scipy.sparse.csgraph``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from repro_torch import api
from repro_torch.core.graph import make_instance, resolve_device
from repro_torch.models.gnn import egnn as eg
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.train.loop import value_and_grad
from repro_torch.train.optimizer import (
    OptimizerConfig, apply_update, init_opt_state,
)

N, E, K = 48, 320, 4          # nodes, candidate edges, planted clusters
STEPS = 60
CFG = eg.EGNNConfig(n_layers=2, d_hidden=24, d_in=4)
SOLVER = api.SolverConfig(max_neg=256, mp_iters=10)


def make_cloud(seed: int, device):
    """Planted-cluster point cloud + candidate edge list: (pos, src, dst,
    same-cluster labels, cluster of each node) on ``device``."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    centers = torch.randn((K, 3), generator=gen) * 4.0
    assign = torch.arange(N) % K
    pos = centers[assign] + torch.randn((N, 3), generator=gen) * 0.6
    src = torch.randint(0, N, (E,), generator=gen)
    dst = (src + torch.randint(1, N, (E,), generator=gen)) % N
    same = (assign[src] == assign[dst]).float()
    return (pos.to(device), src.to(torch.int32).to(device),
            dst.to(torch.int32).to(device), same.to(device),
            assign.to(device))


def edge_logits(params, pos, src, dst):
    dev = pos.device
    g = GraphBatch(nodes=torch.ones((N, 4), device=dev), edges_src=src,
                   edges_dst=dst, edge_feat=torch.zeros((E, 1), device=dev),
                   node_mask=torch.ones(N, dtype=torch.bool, device=dev),
                   edge_mask=torch.ones(E, dtype=torch.bool, device=dev),
                   graph_ids=torch.zeros(N, dtype=torch.int32, device=dev),
                   positions=pos)
    h = eg.node_repr(CFG, params, g)
    hs, hd = h.index_select(0, src), h.index_select(0, dst)
    d2 = ((pos.index_select(0, src) - pos.index_select(0, dst)) ** 2).sum(-1)
    return (hs * hd).sum(-1) - d2 * params["dist_w"][0].abs()


def edge_bce(params, batch):
    pos, src, dst, same, _ = batch
    logit = edge_logits(params, pos, src, dst)
    return torch.mean(torch.clamp(logit, min=0) - logit * same
                      + torch.log1p(torch.exp(-logit.abs())))


def instance(src, dst, logit, device):
    """The multicut instance of the edge costs (the JAX example's padding:
    1 024 edge slots, 64 node slots, so ``auto`` takes the dense path)."""
    return make_instance(src, dst, logit, N, pad_edges=1024, pad_nodes=64,
                         device=device)


def rand_agreement(a, b):
    """Pairwise same/diff agreement between two labelings."""
    a, b = np.asarray(a), np.asarray(b)
    iu = np.triu_indices(len(a), 1)
    return float(np.mean((a[iu[0]] == a[iu[1]]) == (b[iu[0]] == b[iu[1]])))


def threshold_components(src, dst, logit) -> np.ndarray:
    """The baseline: keep the edges with a positive logit, label nodes by
    connected component."""
    keep = logit > 0
    adj = coo_matrix((np.ones(int(keep.sum())), (src[keep], dst[keep])),
                     shape=(N, N))
    return connected_components(adj, directed=False)[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params = eg.init_params(CFG, torch.Generator(device=dev).manual_seed(0))
    params["dist_w"] = torch.ones((1,), device=dev)
    opt = init_opt_state(params)
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=args.steps,
                           weight_decay=0.0)
    losses = []
    for s in range(args.steps):
        loss, grads = value_and_grad(edge_bce, params,
                                     make_cloud(100 + s, dev))
        params, opt, _ = apply_update(ocfg, params, grads, opt)
        losses.append(float(loss))
        if s % 20 == 0:
            print(f"step {s}: edge-BCE {losses[-1]:.4f}")

    # fresh instance -> costs -> RAMA
    pos, src, dst, _, assign = make_cloud(999, dev)
    with torch.no_grad():
        logit = edge_logits(params, pos, src, dst)
    src, dst, logit, assign = (t.cpu().numpy()
                               for t in (src, dst, logit, assign))
    res = api.solve(instance(src, dst, logit, dev), mode="pd",
                    config=SOLVER, device=dev)

    acc_rama = rand_agreement(res.labels.cpu().numpy()[:N], assign)
    acc_thr = rand_agreement(threshold_components(src, dst, logit), assign)
    print(f"\nplanted-cluster pairwise agreement: "
          f"RAMA {acc_rama:.3f}  vs  threshold+CC {acc_thr:.3f}")
    print(f"RAMA objective {float(res.objective):.2f}, "
          f"LB {float(res.lower_bound):.2f}")
    assert acc_rama >= acc_thr - 0.02, "solver should not lose to thresholding"
    print("OK")
    return dict(losses=losses, acc_rama=acc_rama, acc_thr=acc_thr, src=src,
                dst=dst, logit=logit, result=res)


if __name__ == "__main__":
    main()
