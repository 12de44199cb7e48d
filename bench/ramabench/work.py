"""Operations and bytes that a call's inputs need, and the card's peaks.

Frozen copies, so that a change to the program cannot change its own
yardstick:

* :func:`triangle_mp_phase` is the count of
  ``repro_torch.kernels.triangle_mp.ops.work`` (one ``mp_phase`` call),
  worked out here from the call's triangles with numpy in place of the
  program's ``mp_plan``;
* :func:`cycle_intersect` is ``repro_torch.kernels.cycle_intersect.ops.work``
  (one launch on (R, W) x (R, Wj) int32);
* :func:`contraction` is this benchmark's own count for one call of the
  contraction phase (contraction set and contraction), from the live
  edges and nodes it reads and writes.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again, and work that depends on the data is
counted from what these inputs need. A share of the roofline is
``min_seconds / device_seconds``, where ``min_seconds`` is the larger of
operations over the peak rate and bytes over the peak bandwidth.
"""
from __future__ import annotations

import math

import numpy as np

# One NVIDIA H100 SXM (80 GB HBM3), NVIDIA's published peaks at 700 W:
# HBM3 bandwidth; FP32 outside the tensor cores; INT32 (H100 whitepaper).
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_ops_per_s": 67e12,
         "int32_ops_per_s": 33.5e12}

SWEEP_FLOPS = 50        # float ops of one triangle's sweep: 6 steps x ~8


def triangle_mp_phase(tri: np.ndarray, tri_valid: np.ndarray,
                      iters: int) -> tuple[int, int]:
    """(float ops, bytes) of one ``mp_phase`` call on triangles ``tri``
    (T, 3) edge ids with row flags ``tri_valid``, ``iters`` passes.

    Bytes: the row flags, the valid rows' edge ids, the sorted keys and
    entries of their slots and the touched edges' costs read once, the
    valid rows' costs and the touched edges' reparametrised costs written
    once. Ops: each pass a slot adds its edge's entries (+3) and the sweep
    takes ~50 a triangle; the landing adds each edge's entries once more."""
    T = int(tri.shape[0])
    valid = np.asarray(tri_valid, dtype=bool)
    nv = int(valid.sum())
    _, seg = np.unique(np.asarray(tri)[valid].reshape(-1),
                       return_counts=True)
    U = int(seg.size)
    slot_adds = int((seg.astype(np.int64) ** 2).sum())
    bytes_moved = T + 12 * nv + 3 * nv * (4 + 8) + 4 * U + 12 * nv + 4 * U
    ops = iters * (slot_adds + 9 * nv + SWEEP_FLOPS * nv) \
        + int(seg.sum()) + U
    return ops, bytes_moved


def cycle_intersect(R: int, W: int, Wj: int) -> tuple[int, int]:
    """(integer ops, bytes) of one launch: both inputs read and the (R, W)
    output written once; one upper-bound search of ceil(log2(Wj + 1))
    compares per element, 2 ops each (compare and select)."""
    return 2 * R * W * math.ceil(math.log2(Wj + 1)), 4 * (2 * R * W + R * Wj)


def contraction(edges_in: int, nodes_in: int, edges_out: int,
                nodes_out: int) -> int:
    """Bytes of one contraction call on its live edges and nodes: each
    live edge's endpoints, cost and flag (13 B) and its contraction-set
    flag (1 B) read; each live node's flag read (1 B) and its cluster id
    written (4 B); each live edge of the result written (13 B) with its
    two adjacency entries of column and edge id (16 B); each live node of
    the result's row offset written (4 B)."""
    return 14 * edges_in + 5 * nodes_in + 29 * edges_out + 4 * nodes_out


def min_seconds(ops: float, nbytes: float, ops_peak: str) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAKS[ops_peak], nbytes / PEAKS["hbm_bytes_per_s"])
