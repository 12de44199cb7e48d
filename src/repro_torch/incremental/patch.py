"""Graph deltas: the :class:`DeltaPatch` COO patch, its host builder and
validator, and its application onto a carried (instance, CSR) pair.

Port of ``repro.incremental.patch``. A patch is a padded array of
undirected edge operations:

* **upsert** (``delete=False``) — set the edge's cost, inserting the edge
  into a free padded slot if it does not exist (``make_patch``'s
  ``insert=`` and ``reweight=`` both lower to this; whether the edge
  exists is device state);
* **delete** (``delete=True``) — remove the edge if present (its slot is
  freed and zeroed), a no-op if absent.

Validation mirrors :func:`repro_torch.core.graph.make_instance`: equal 1-D
lengths, node ids in range, no duplicate (u, v) pair within one patch, no
self-loop. Slot policy, mirrored by :func:`apply_patch_host`: deletions
free their slot in place; insertions fill free slots ascending, in
patch-entry order; insertions past the free-slot capacity are dropped
(``PatchInfo.n_dropped`` counts them).

:func:`apply_patch` is fixed-shape and issues no host sync. Every scatter
in it writes distinct positions (pairs are unique within a patch, free
ranks are unique) or the same value, so its result does not depend on
scatter order; the one float sum, ``lb_slack``, is accumulated in float64
and rounded once, so every device gives it the same value.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import (
    CsrGraph, MulticutInstance, csr_lookup_edge, resolve_device, splice_csr,
)

__all__ = ["DeltaPatch", "PatchInfo", "apply_patch", "apply_patch_host",
           "make_patch", "pad_patch"]


class DeltaPatch(NamedTuple):
    """Padded COO edge patch. ``valid`` masks live entries; a valid entry
    upserts (sets the cost of) edge (u, v), or deletes it when ``delete``."""
    u: torch.Tensor         # (P,) int32
    v: torch.Tensor         # (P,) int32
    cost: torch.Tensor      # (P,) float32 new cost (upserts; 0 for deletes)
    delete: torch.Tensor    # (P,) bool
    valid: torch.Tensor     # (P,) bool

    @property
    def num_entries(self) -> int:
        return self.u.shape[0]

    def to(self, device) -> "DeltaPatch":
        return DeltaPatch(*(t.to(device) for t in self))


class PatchInfo(NamedTuple):
    """Application report (0-dim tensors)."""
    n_inserted: torch.Tensor    # i32 edges newly allocated
    n_deleted: torch.Tensor     # i32 edges removed
    n_reweighted: torch.Tensor  # i32 existing edges with cost set
    n_dropped: torch.Tensor     # i32 inserts lost to missing free slots
    lb_slack: torch.Tensor      # f32 Σ_e min(0, Δcost_e) over the applied
                                # ops: for any clustering y, ⟨c+Δ, y⟩ ≥
                                # ⟨c, y⟩ + Σ min(0, Δ), so a pre-patch
                                # bound plus this stays valid. Deletes
                                # give −old cost, inserts +new cost,
                                # reweights new − old, dropped inserts 0


def make_patch(num_nodes: int, *, insert=None, delete=None, reweight=None,
               pad_entries: int | None = None, device=None) -> DeltaPatch:
    """Build a validated, padded :class:`DeltaPatch` from host arrays on
    ``device`` (default ``cuda``; raises without a card unless told).

    ``insert``/``reweight`` are (u, v, cost) triples, ``delete`` a (u, v)
    pair, each of arrays or lists. ``pad_entries`` fixes the capacity P;
    it defaults to the entry count (min 1)."""
    groups = []
    for name, grp, has_cost in (("insert", insert, True),
                                ("reweight", reweight, True),
                                ("delete", delete, False)):
        if grp is None:
            continue
        if has_cost:
            if len(grp) != 3:
                raise ValueError(f"{name} must be a (u, v, cost) triple")
            gu, gv, gc = grp
        else:
            if len(grp) != 2:
                raise ValueError(f"{name} must be a (u, v) pair")
            gu, gv = grp
            gc = np.zeros(len(np.atleast_1d(gu)), dtype=np.float32)
        gu = np.asarray(gu, dtype=np.int32)
        gv = np.asarray(gv, dtype=np.int32)
        gc = np.asarray(gc, dtype=np.float32)
        if not (gu.shape == gv.shape == gc.shape and gu.ndim == 1):
            raise ValueError(
                f"{name}: u/v/cost must be 1-D arrays of equal length; got "
                f"shapes {gu.shape}/{gv.shape}/{gc.shape}")
        groups.append((gu, gv, gc, name == "delete"))

    if groups:
        u = np.concatenate([g[0] for g in groups])
        v = np.concatenate([g[1] for g in groups])
        c = np.concatenate([g[2] for g in groups])
        is_del = np.concatenate([np.full(len(g[0]), g[3]) for g in groups])
    else:
        u = v = np.zeros(0, np.int32)
        c = np.zeros(0, np.float32)
        is_del = np.zeros(0, bool)

    if len(u):
        if u.min() < 0 or v.min() < 0 or max(u.max(), v.max()) >= num_nodes:
            bad = np.where((u < 0) | (v < 0) | (u >= num_nodes)
                           | (v >= num_nodes))[0][0]
            raise ValueError(
                f"patch node ids must lie in [0, {num_nodes}); entry "
                f"{int(bad)} is ({int(u[bad])}, {int(v[bad])})")
        if (u == v).any():
            bad = int(np.where(u == v)[0][0])
            raise ValueError(
                f"patch entries may not be self-loops; entry {bad} is "
                f"({int(u[bad])}, {int(u[bad])})")
        pairs = np.stack([np.minimum(u, v), np.maximum(u, v)], axis=1)
        uniq, counts = np.unique(pairs, axis=0, return_counts=True)
        if (counts > 1).any():
            dup = uniq[np.argmax(counts > 1)]
            raise ValueError(
                f"duplicate (u, v) pair within one patch: "
                f"({int(dup[0])}, {int(dup[1])}) appears "
                f"{int(counts.max())} times — two ops on one edge in one "
                f"tick have no defined order; merge them host-side")
    P = len(u)
    Pp = pad_entries if pad_entries is not None else max(1, P)
    if Pp < max(1, P):
        raise ValueError(f"pad_entries={Pp} cannot hold {P} patch entries")
    uu = np.zeros(Pp, np.int32); uu[:P] = u
    vv = np.zeros(Pp, np.int32); vv[:P] = v
    cc = np.zeros(Pp, np.float32); cc[:P] = c
    dd = np.zeros(Pp, bool); dd[:P] = is_del
    ok = np.zeros(Pp, bool); ok[:P] = True
    dev = resolve_device(device)
    return DeltaPatch(*(torch.from_numpy(a).to(dev)
                        for a in (uu, vv, cc, dd, ok)))


def _pad_tail(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.cat([x, torch.zeros(d, dtype=x.dtype, device=x.device)])


def pad_patch(patch: DeltaPatch, pad_entries: int) -> DeltaPatch:
    """Re-pad a patch to capacity ``pad_entries`` — how the serving tier
    lifts per-session patches onto their bucket's patch capacity. Cutting
    capacity is allowed only past the last live entry."""
    P = patch.num_entries
    if pad_entries < P:
        if bool(patch.valid[pad_entries:].any()):
            raise ValueError(
                f"patch has live entries past index {pad_entries}; "
                f"capacity {pad_entries} cannot hold it")
        return DeltaPatch(*(x[:pad_entries] for x in patch))
    d = pad_entries - P
    return DeltaPatch(*(_pad_tail(x, d) for x in patch))


def _set(base: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``base.at[idx].set(vals, mode="drop")`` for ``idx`` in [0, len]:
    position ``len(base)`` is the drop slot."""
    out = torch.cat([base, base.new_zeros(1)])
    vals = torch.as_tensor(vals, dtype=base.dtype, device=base.device) \
        .expand(idx.shape)
    return out.scatter_(0, idx.long(), vals)[:len(base)]


def apply_patch(inst: MulticutInstance, csr: CsrGraph, patch: DeltaPatch):
    """Apply a patch: returns ``(inst2, csr2, PatchInfo)`` with ``csr2``
    spliced (never rebuilt), equal to ``build_csr`` of ``inst2``. An upsert
    of an existing edge sets its cost, of a missing edge allocates a free
    slot; a delete of a missing edge is a no-op."""
    E = inst.num_edges
    dev = inst.cost.device
    lo = torch.minimum(patch.u, patch.v).to(torch.int32)
    hi = torch.maximum(patch.u, patch.v).to(torch.int32)
    valid = patch.valid & (lo != hi)
    eid = csr_lookup_edge(csr, lo, hi)
    exists = valid & (eid >= 0)
    E_t = torch.full_like(eid, E)

    # deletes: free the slot in place (zeroed, like make_instance padding)
    is_del = exists & patch.delete
    drop = _set(torch.zeros(E, dtype=torch.bool, device=dev),
                torch.where(is_del, eid, E_t), True)

    # upserts on existing edges: cost only (the CSR is untouched by these)
    upd = exists & ~patch.delete
    cost1 = _set(inst.cost, torch.where(upd, eid, E_t), patch.cost)

    zi = torch.zeros_like(inst.u)
    u1 = torch.where(drop, zi, inst.u)
    v1 = torch.where(drop, zi, inst.v)
    c1 = torch.where(drop, torch.zeros_like(cost1), cost1)
    ev1 = inst.edge_valid & ~drop

    # inserts: missing upserts fill free slots ascending, patch-entry order
    fresh = valid & ~patch.delete & (eid < 0)
    free = ~inst.edge_valid | drop
    free_rank = torch.cumsum(free.to(torch.int32), 0, dtype=torch.int32) - 1
    ar = torch.arange(E, dtype=torch.int32, device=dev)
    slot_of_rank = _set(torch.full((E,), -1, dtype=torch.int32, device=dev),
                        torch.where(free, free_rank,
                                    torch.full_like(free_rank, E)), ar)
    want_rank = torch.cumsum(fresh.to(torch.int32), 0,
                             dtype=torch.int32) - 1
    ok_alloc = fresh & (want_rank < free.sum())
    slot = torch.where(ok_alloc,
                       slot_of_rank[want_rank.clamp(0, max(E - 1, 0)).long()],
                       E_t)

    inst2 = MulticutInstance(u=_set(u1, slot, lo), v=_set(v1, slot, hi),
                             cost=_set(c1, slot, patch.cost),
                             edge_valid=_set(ev1, slot, True),
                             node_valid=inst.node_valid)
    csr2 = splice_csr(csr, drop, lo, hi,
                      torch.where(ok_alloc, slot, torch.zeros_like(slot))
                      .to(torch.int32), ok_alloc)
    # per-entry cost delta: the old cost for resolved entries (0 for
    # inserts — the edge did not exist, so its implicit old cost is 0)
    zc = torch.zeros_like(patch.cost)
    old_cost = torch.where(exists, inst.cost[eid.clamp(min=0).long()], zc)
    delta = torch.where(is_del, -old_cost,
                        torch.where(upd | ok_alloc, patch.cost - old_cost,
                                    zc))
    i32 = torch.int32
    info = PatchInfo(
        n_inserted=ok_alloc.sum().to(i32), n_deleted=is_del.sum().to(i32),
        n_reweighted=upd.sum().to(i32),
        n_dropped=(fresh & ~ok_alloc).sum().to(i32),
        lb_slack=delta.clamp(max=0.0).to(torch.float64).sum()
        .to(torch.float32))
    return inst2, csr2, info


def apply_patch_host(inst: MulticutInstance,
                     patch: DeltaPatch) -> MulticutInstance:
    """Host (numpy) reference of :func:`apply_patch`'s instance update, on
    the instance's device: the same slots, the same values, slot for slot
    (vectorised: a sorted-key lookup of each entry's first live slot, as
    the reference's per-entry scan finds it). The cold side of the
    exactness checks."""
    u = inst.u.cpu().numpy().copy(); v = inst.v.cpu().numpy().copy()
    c = inst.cost.cpu().numpy().copy()
    ev = inst.edge_valid.cpu().numpy().copy()
    pu = patch.u.cpu().numpy(); pv = patch.v.cpu().numpy()
    pc = patch.cost.cpu().numpy()
    pdel = patch.delete.cpu().numpy(); pval = patch.valid.cpu().numpy()
    lo, hi = np.minimum(pu, pv), np.maximum(pu, pv)
    valid = pval & (lo != hi)

    # pass 1: resolve against the PRE-patch edge set (what the CSR lookup
    # sees on device): the first live slot holding each entry's pair
    n = np.int64(max(inst.num_nodes, 1))
    live = np.flatnonzero(ev)
    order = np.argsort(u[live].astype(np.int64) * n + v[live], kind="stable")
    keys = (u[live].astype(np.int64) * n + v[live])[order]
    q = lo.astype(np.int64) * n + hi
    eid = np.full(len(q), -1, dtype=np.int64)
    if len(keys):
        pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        eid = np.where(valid & (keys[pos] == q), live[order[pos]], -1)
    is_del = valid & pdel & (eid >= 0)
    upd = valid & ~pdel & (eid >= 0)
    fresh = valid & ~pdel & (eid < 0)

    c[eid[upd]] = pc[upd]
    gone = eid[is_del]
    u[gone] = 0; v[gone] = 0; c[gone] = 0.0; ev[gone] = False
    # inserts fill free slots ascending, in entry order; the rest drop
    free = np.flatnonzero(~ev)
    take = np.flatnonzero(fresh)[:len(free)]
    slots = free[:len(take)]
    u[slots] = lo[take]; v[slots] = hi[take]; c[slots] = pc[take]
    ev[slots] = True
    dev = inst.device
    return MulticutInstance(*(torch.from_numpy(a).to(dev)
                              for a in (u, v, c, ev)),
                            node_valid=inst.node_valid)
