"""The paper's own solver config: RAMA primal-dual multicut (port of
``repro.configs.rama_multicut``).

Cells:
  pd_round_sm / pd_round_lg — one full separation → MP → contract round on
      one card (the per-block workload of the distributed solver);
  mp_sweep_1m — the message-passing phase at 1M triangles (the
      triangle_mp kernel's production shape);
  dist_pd — the domain-decomposed round over the default
      ``torch.distributed`` group (one block per rank; one rank holds
      every block without a group), ``core/dist.py``'s
      ``make_dist_pd_round``.

Plans (the reference's): the solver and MP cells run replicated (plain
tensors, the same on every rank); dist_pd's block arrays shard their
block axis over every mesh axis (:meth:`RamaArch.dist_inputs`: one block
a rank) and its boundary costs stay whole. No state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeCell, register
from repro_torch.core.graph import MulticutInstance
from repro_torch.core.solver import _dual_round, _primal_round, \
    resolve_intersect, resolve_mp
from repro_torch.sharding import P, Sharding, axis_sizes, prod_axes

RAMA_SHAPES = {
    "pd_round_sm": ShapeCell("pd_round_sm", "solver",
                             dict(n_nodes=1024, n_edges=8192)),
    "pd_round_lg": ShapeCell("pd_round_lg", "solver",
                             dict(n_nodes=4096, n_edges=32768)),
    "mp_sweep_1m": ShapeCell("mp_sweep_1m", "mp",
                             dict(n_edges=1 << 20, n_triangles=1 << 20)),
    "dist_pd": ShapeCell("dist_pd", "dist",
                         dict(blk_nodes=1024, blk_edges=8192,
                              boundary_edges=65536)),
}


def _default_group():
    """The default process group, or None (one rank) without one."""
    return dist.group.WORLD if dist.is_initialized() else None


@dataclasses.dataclass(frozen=True)
class RamaArch:
    id: str = "rama-multicut"
    family: str = "multicut"
    mp_iters: int = 5
    max_neg: int = 256
    max_tri_per_edge: int = 4

    @property
    def shapes(self):
        return RAMA_SHAPES

    def abstract_inputs(self, shape: ShapeCell) -> dict:
        """The step's inputs as ``meta`` tensors (shapes and dtypes, no
        memory)."""
        d = shape.dims

        def meta(n, dtype):
            return torch.empty(n, dtype=dtype, device="meta")
        f32, i32, b = torch.float32, torch.int32, torch.bool
        if shape.kind == "solver":
            N, E = d["n_nodes"], d["n_edges"]
            return {"u": meta((E,), i32), "v": meta((E,), i32),
                    "cost": meta((E,), f32), "edge_valid": meta((E,), b),
                    "node_valid": meta((N,), b)}
        if shape.kind == "mp":
            E, T = d["n_edges"], d["n_triangles"]
            return {"cost": meta((E,), f32), "edge_valid": meta((E,), b),
                    "tri": meta((T, 3), i32), "tri_valid": meta((T,), b)}
        if shape.kind == "dist":
            # the reference's dist_inputs: one block per rank
            nb = dist.get_world_size() if dist.is_initialized() else 1
            Eb, Nb = d["blk_edges"], d["blk_nodes"]
            return {"u": meta((nb, Eb), i32), "v": meta((nb, Eb), i32),
                    "cost": meta((nb, Eb), f32),
                    "edge_valid": meta((nb, Eb), b),
                    "node_valid": meta((nb, Nb), b),
                    "boundary_cost": meta((d["boundary_edges"],), f32)}
        raise ValueError(shape.kind)

    def dist_inputs(self, mesh, shape: ShapeCell) -> dict:
        """dist_pd's inputs on ``mesh`` as meta tensors: one block per
        rank of the mesh."""
        d = shape.dims
        nb = prod_axes(mesh, tuple(axis_sizes(mesh)))
        Eb, Nb = d["blk_edges"], d["blk_nodes"]
        f32, i32, b = torch.float32, torch.int32, torch.bool

        def meta(n, dtype):
            return torch.empty(n, dtype=dtype, device="meta")
        return {"u": meta((nb, Eb), i32), "v": meta((nb, Eb), i32),
                "cost": meta((nb, Eb), f32),
                "edge_valid": meta((nb, Eb), b),
                "node_valid": meta((nb, Nb), b),
                "boundary_cost": meta((d["boundary_edges"],), f32)}

    def state_shardings(self, mesh, shape: ShapeCell) -> dict:
        return {}

    def input_shardings(self, mesh, shape: ShapeCell) -> dict:
        if shape.kind == "dist":
            axes = tuple(axis_sizes(mesh))
            return {k: Sharding(mesh, P(None) if k == "boundary_cost"
                                else P(axes, None))
                    for k in self.dist_inputs(mesh, shape)}
        return {k: Sharding(mesh, P(*([None] * v.dim())))
                for k, v in self.abstract_inputs(shape).items()}

    def step_fn(self, shape: ShapeCell) -> Callable:
        """The cell's step as a plain tensor function: ``pd_round(u, v,
        cost, edge_valid, node_valid)`` -> (u', v', cost', edge_valid',
        node_valid', mapping, lb) through ``_dual_round``/``_primal_round``,
        ``mp_step(cost, edge_valid, tri, tri_valid)`` -> (c_rep, lb)
        through the fused MP phase, or the dist_pd round ``dist_round(u,
        v, cost, edge_valid, node_valid, boundary_cost)`` over the default
        process group (``core.dist.make_dist_pd_round``); all run the hand
        kernels on CUDA tensors (their plain versions on CPU tensors)."""
        mp = resolve_mp("cuda")
        if shape.kind == "solver":
            mpi, mn, mt = self.mp_iters, self.max_neg, self.max_tri_per_edge
            intersect = resolve_intersect("cuda")

            def pd_round(u, v, cost, edge_valid, node_valid):
                inst = MulticutInstance(u=u, v=v, cost=cost,
                                        edge_valid=edge_valid,
                                        node_valid=node_valid)
                inst2, c_rep, lb = _dual_round(inst, mpi, mn, mt, 4, True,
                                               mp=mp, intersect=intersect)
                res = _primal_round(inst2._replace(cost=c_rep), 3, 4, 0.1)
                out = res.instance
                return (out.u, out.v, out.cost, out.edge_valid,
                        out.node_valid, res.mapping, lb)
            return pd_round
        if shape.kind == "mp":
            mpi = self.mp_iters

            def mp_step(cost, edge_valid, tri, tri_valid):
                _, c_rep, lb = mp(cost, edge_valid, tri, tri_valid, mpi)
                return c_rep, lb
            return mp_step
        if shape.kind == "dist":
            from repro_torch.core.dist import make_dist_pd_round
            return make_dist_pd_round(_default_group(), mp_iters=3,
                                      max_neg=128,
                                      max_tri_per_edge=self.max_tri_per_edge)
        raise ValueError(shape.kind)

    def model_flops(self, shape: ShapeCell) -> float:
        d = shape.dims
        if shape.kind == "mp":
            # ~60 flops per triangle per sweep x iters
            return 60.0 * d["n_triangles"] * self.mp_iters
        if shape.kind == "solver":
            # separation row-dots (2*max_neg*nbr_k^2*N) + message passing
            # over the separated triangles
            N = d["n_nodes"]
            tri = self.max_neg * (self.max_tri_per_edge + 4)
            return (2.0 * self.max_neg * 16 * N
                    + 60.0 * tri * self.mp_iters)
        blkN = d["blk_nodes"]
        tri = 128 * (self.max_tri_per_edge + 4)
        return 2.0 * 128 * 16 * blkN + 60.0 * tri * 3  # per device


ARCH = register(RamaArch())
