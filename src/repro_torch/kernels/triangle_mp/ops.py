"""Wrappers of the triangle_mp kernels (``csrc/triangle_mp.cu``).

``mp_sweep``: the sweep alone, (T, 3) float32 in, (T, 3) out — the direct
counterpart of the TPU kernel. ``mp_phase``: one whole message-passing
phase on compact triangle-edge ids, (cost, edge_valid, tri, tri_valid,
iters) → (t_cost, c_rep, lb) — what the solver runs.

Both route by the tensors' device: CUDA tensors launch the hand-written
kernel or raise; CPU tensors run the plain version (``ref.mp_sweep_ref``,
``ref.mp_phase_ref``). Nothing falls back quietly. ``launches`` counts
kernel launches, and nothing else adds to it: one per ``mp_sweep`` call;
one per ``mp_phase`` call when T <= ``FUSED_MAX_T`` (the whole phase in
one block), else ``iters`` pass launches and one landing launch.
``shapes`` counts the T of each nonempty call on either device, so a run
can show which shapes its path gave the kernels. There is no padding:
the kernels mask their own ragged tails.

``sweep_work`` and ``work`` give the float ops and bytes one call's
kernel launches need (each input byte read once, each output byte written
once): what a roofline bound or a profile's accounting counts for a
kernel that launches through ``ctypes``, out of sight of PyTorch's
dispatcher.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.triangle_mp.ref import lower_bound_terms, \
    mp_phase_ref, mp_plan, mp_sweep_ref

FUSED_MAX_T = 2048      # the phase's two (T, 3) planes fit in 48 KB
SWEEP_FLOPS = 50        # float ops of one triangle's sweep: 6 steps x ~8

launches = 0
shapes: Counter = Counter()     # T of each nonempty call
_sweep = _build.Launcher("triangle_mp", "triangle_mp_sweep")
_phase = _build.Launcher("triangle_mp", "triangle_mp_phase")


def _unsupported(name: str, dev) -> ValueError:
    return ValueError(f"{name}: unsupported device {dev}")


def mp_sweep(t_cost: torch.Tensor) -> torch.Tensor:
    """Drop-in for ``mp_sweep_reference``: (T, 3) float32 → (T, 3)."""
    global launches
    index = t_cost.get_device()             # -1: not a CUDA tensor
    if index < 0:
        if t_cost.device.type != "cpu":
            raise _unsupported("mp_sweep", t_cost.device)
        if t_cost.shape[0]:
            shapes[t_cost.shape[0]] += 1
        return mp_sweep_ref(t_cost)
    if t_cost.dtype is not torch.float32 or t_cost.dim() != 2 \
            or t_cost.shape[1] != 3:
        raise ValueError(f"mp_sweep: need (T, 3) float32, got "
                         f"{tuple(t_cost.shape)} {t_cost.dtype}")
    x = t_cost.contiguous()
    out = torch.empty_like(x)
    T = x.shape[0]
    if T == 0:
        return out
    _sweep(index, x.data_ptr(), out.data_ptr(), T)
    launches += 1
    shapes[T] += 1
    return out


def _check_phase(cost, edge_valid, tri, tri_valid, iters):
    dev = cost.device
    for name, t in (("edge_valid", edge_valid), ("tri", tri),
                    ("tri_valid", tri_valid)):
        if t.device != dev:
            raise ValueError(f"mp_phase: cost on {dev}, {name} on "
                             f"{t.device}")
    if cost.dtype is not torch.float32 or cost.dim() != 1 \
            or edge_valid.dtype is not torch.bool \
            or edge_valid.shape != cost.shape:
        raise ValueError(f"mp_phase: need cost (E,) float32 and edge_valid "
                         f"(E,) bool, got {tuple(cost.shape)} {cost.dtype}, "
                         f"{tuple(edge_valid.shape)} {edge_valid.dtype}")
    if tri.dtype is not torch.int32 or tri.dim() != 2 or tri.shape[1] != 3 \
            or tri_valid.dtype is not torch.bool \
            or tri_valid.shape != tri.shape[:1]:
        raise ValueError(f"mp_phase: need tri (T, 3) int32 and tri_valid "
                         f"(T,) bool, got {tuple(tri.shape)} {tri.dtype}, "
                         f"{tuple(tri_valid.shape)} {tri_valid.dtype}")
    if not isinstance(iters, int) or iters < 0:
        raise ValueError(f"mp_phase: iters must be an int >= 0, got "
                         f"{iters!r}")


def mp_phase(cost: torch.Tensor, edge_valid: torch.Tensor,
             tri: torch.Tensor, tri_valid: torch.Tensor, iters: int):
    """``iters`` passes of Alg. 2 from zero triangle costs on triangles
    ``tri`` (T, 3) int32 edge ids over ``cost`` (E,). Returns (t_cost
    (T, 3), c_rep (E,), lb ()), bitwise equal to ``mp_phase_ref``."""
    global launches
    _check_phase(cost, edge_valid, tri, tri_valid, iters)
    index = cost.get_device()
    T, E = tri.shape[0], cost.shape[0]
    if index < 0:
        if cost.device.type != "cpu":
            raise _unsupported("mp_phase", cost.device)
        if T:
            shapes[T] += 1
        return mp_phase_ref(cost, edge_valid, tri, tri_valid, iters)
    t_cost = torch.zeros((T, 3), dtype=torch.float32, device=cost.device)
    c_rep = cost + 0.0
    if T and E:
        if E >= 2**31:
            raise ValueError(f"mp_phase: {E} edges; edge ids are int32")
        cost, tri = cost.contiguous(), tri.contiguous()
        tri_valid = tri_valid.contiguous()
        # the compact layout: the valid slots' edge ids, sorted stably
        # (E at invalid rows' slots sorts after every edge); the kernel
        # finds each slot's run of equal keys itself
        keys, entries = torch.sort(
            torch.where(tri_valid[:, None], tri, E).view(-1), stable=True)
        fused = T <= FUSED_MAX_T
        scratch = t_cost if fused else torch.zeros_like(t_cost)
        segs = torch.empty((T, 3, 4), dtype=torch.int32, device=cost.device)
        _phase(index, tri.data_ptr(), tri_valid.data_ptr(),
               cost.data_ptr(), keys.data_ptr(), entries.data_ptr(),
               segs.data_ptr(), t_cost.data_ptr(), scratch.data_ptr(),
               c_rep.data_ptr(), T, iters)
        launches += 1 if fused else iters + 1
        shapes[T] += 1
    return t_cost, c_rep, lower_bound_terms(c_rep, edge_valid, t_cost,
                                            tri_valid)


def sweep_work(T: int) -> tuple[int, int]:
    """(float ops, bytes) of one ``mp_sweep`` launch on (T, 3) float32:
    the triangles read and written once, ~50 ops a triangle."""
    return SWEEP_FLOPS * T, 24 * T


def work(cost: torch.Tensor, tri: torch.Tensor, tri_valid: torch.Tensor,
         iters: int) -> tuple[int, int]:
    """(float ops, bytes) of the kernel launches of one ``mp_phase`` call
    on these inputs, counted from what this data needs (it syncs to read
    the plan's sizes; a host accounting function, not for the hot path).

    Bytes: the row flags, the valid rows' edge ids, the sorted keys and
    entries of their slots and the touched edges' costs read once, the
    valid rows' costs and the touched edges' c_rep written once. Ops: each
    pass a slot adds its segment's entries (+3: c + Σ, / deg, + t) and
    the sweep takes ~50; the landing adds each segment once more."""
    plan = mp_plan(cost, tri, tri_valid)
    nv = int(tri_valid.sum())
    seg = plan.length[plan.length > 0].long()
    U = int(seg.numel())
    slot_adds = int((seg * seg).sum())      # Σ over valid slots of deg
    T = tri.shape[0]
    bytes_moved = T + 12 * nv + 3 * nv * (4 + 8) + 4 * U + 12 * nv + 4 * U
    ops = iters * (slot_adds + 9 * nv + SWEEP_FLOPS * nv) \
        + int(seg.sum()) + U
    return ops, bytes_moved
