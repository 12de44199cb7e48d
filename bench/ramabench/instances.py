"""Multicut instances made on the host from a seed.

:func:`grid` is a frozen copy of ``repro_torch.core.graph.grid_instance``
(the port's Cityscapes-like generator, as it stood when this benchmark was
added): the same draws in the same order, so one seed gives the same
edges and costs. It also returns the planted segmentation that the costs
were drawn from, which the reference's control uses. Grid edges are
distinct pairs with ``u < v``, so the program's ``make_instance`` would
keep them in this order; :func:`to_program` therefore lays them out
directly, padded with invalid slots, without its de-duplication pass.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LONG_RANGE_OFFSETS = ((0, 4), (4, 0), (3, 3))


@dataclass
class HostInstance:
    """One instance as the benchmark made it: ``u < v`` (int32), ``cost``
    (float32), ``num_nodes`` nodes, ``pad_edges`` edge slots in the
    program's layout (the valid edges first), and ``planted`` labels."""
    u: np.ndarray
    v: np.ndarray
    cost: np.ndarray
    num_nodes: int
    pad_edges: int
    planted: np.ndarray

    @property
    def num_edges(self) -> int:
        return len(self.u)


def grid(h: int, w: int, seed, noise: float = 0.4, n_segments: int = 6,
         long_range: bool = True, chord_slots: int = 0) -> HostInstance:
    """A ``h`` x ``w`` pixel grid: 4-neighbours plus the long-range
    offsets, costs +1 inside a planted segment and -1 across, with
    Gaussian noise of standard deviation ``2 * noise``. ``chord_slots``
    invalid edge slots follow the valid edges (room for separation's
    chords). ``seed`` is anything ``numpy.random.default_rng`` takes."""
    rng = np.random.default_rng(seed)
    cy = rng.uniform(0, h, n_segments)
    cx = rng.uniform(0, w, n_segments)
    yy, xx = np.mgrid[0:h, 0:w]
    d = (yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2
    seg = d.argmin(-1).ravel()
    idx = np.arange(h * w).reshape(h, w)
    us = [idx[:, :-1].ravel(), idx[:-1, :].ravel()]
    vs = [idx[:, 1:].ravel(), idx[1:, :].ravel()]
    if long_range:
        for dy, dx in LONG_RANGE_OFFSETS:
            if h > dy and w > dx:
                us.append(idx[: h - dy, : w - dx].ravel())
                vs.append(idx[dy:, dx:].ravel())
    u = np.concatenate(us)
    v = np.concatenate(vs)
    same = (seg[u] == seg[v]).astype(np.float32)
    base = np.where(same, 1.0, -1.0)
    cost = base + rng.normal(0, noise * 2, size=len(u)).astype(np.float32)
    return HostInstance(u=u.astype(np.int32), v=v.astype(np.int32),
                        cost=cost.astype(np.float32), num_nodes=h * w,
                        pad_edges=len(u) + chord_slots, planted=seg)


def to_program(inst: HostInstance, device, cost=None):
    """The program's ``MulticutInstance`` of ``inst`` on ``device``: the
    valid edges first, then ``pad_edges - num_edges`` invalid zero slots.
    ``cost`` replaces the costs (the precision control rounds them)."""
    import torch

    from repro_torch.core.graph import MulticutInstance

    E, Ep = inst.num_edges, inst.pad_edges
    c = inst.cost if cost is None else cost

    def padded(a, dtype):
        out = torch.zeros(Ep, dtype=dtype, device=device)
        out[:E] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return out

    valid = torch.zeros(Ep, dtype=torch.bool, device=device)
    valid[:E] = True
    return MulticutInstance(
        u=padded(inst.u, torch.int32), v=padded(inst.v, torch.int32),
        cost=padded(c, torch.float32), edge_valid=valid,
        node_valid=torch.ones(inst.num_nodes, dtype=torch.bool,
                              device=device))
