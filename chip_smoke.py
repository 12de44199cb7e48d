#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, in order; any failure exits nonzero with no ``ok`` line:

1. Environment: the card's name and power limit, torch and CUDA versions;
   builds the four kernels from ``src/repro_torch/csrc`` (one nvcc each,
   in parallel) and prints the build seconds, then ptxas's report of
   each kernel function (registers, stack and spill bytes, its notes on
   serialized wgmma or an ignored setmaxnreg).
2. Kernels against their plain PyTorch versions on the card, at the
   listed shapes: ``triangle_mp`` must be bitwise equal (the sweep alone
   at T = 2^20 and 1 000 003, with its profiled device µs with its inputs
   flushed from L2 and its share of the bytes bound; the fused MP phase,
   t_cost, c_rep and lower bound, at the solver's T = 1 024 and 2 048
   with few valid rows, a ragged T and T = 2^20, with its launches, the
   profiled device µs of its kernels and of the whole call, and the
   kernels' bound from the reads and writes these inputs need),
   ``cycle_intersect``
   exactly equal (each case also gets host µs per call, 1 000 calls then
   one synchronise, and profiled device µs per call, for the kernel and
   for ``torch.searchsorted``; then the host µs of each step of its launch
   path at the main-path head shape, the former wrapper's steps replayed
   against this one's), ``flash_attention`` within atol 1e-2 + rtol 1e-2 of
   ``chunked_attention`` (bf16 output: about one bf16 ulp) and equal bits
   from two launches, at gemma2-9b's global and local layer shapes
   (S = 8192), phi3-mini's and granite-34b's (S = 4096), a ragged S,
   S = 1, a window narrower than a key tile, S = 129, Hq = Hkv, D = 96
   with a window, and the global shape without softcap (each with its
   TFLOP/s and share of the bound, and the name of the kernel the
   yardstick ran); ``contract_matmul`` (KᵀAK − diag, two product
   launches and four split passes, 3xTF32 on the tensor cores) within
   max |Δ| / max |ref| <= 1e-5 of its plain version at
   the five (N, M) shapes of ``tests/test_kernels.py``, the bench shape
   (2048, 512) and (8192, 2048), with its TFLOP/s, its share of the
   3xTF32 bound (the FP32-pipe bound beside it) and its peak device
   memory. Times are CUDA-event medians; the flash
   cases also time ``scaled_dot_product_attention`` with the softcap (and
   window) off as a yardstick, the contraction cases the same two
   products through cuBLAS SGEMM (``torch.matmul``, TF32 off).
3. The main path at full size: ``api.solve`` with the default preset on
   ``grid_instance(512, 1024)`` (524 288 nodes, 2 609 161 edges), through
   both hand kernels (their launch counters are zeroed just before and read
   just after: one ``triangle_mp`` launch for each MP phase of T <= 2 048,
   and no call of the per-edge MP sums), then the same solve with
   ``backend="reference"`` (the per-edge MP layout): labels,
   rounds, histories, objective and lower bound must be equal. Checks the
   lower bound ≤ objective, the labels form a partition, and the objective
   against a float64 recount on the host. Prints wall time (median of 3
   after a warm-up), rounds, host syncs per solve (none may come from
   ``segment_plan``) and peak memory, and a profiled solve's phases (each
   ``repro.*`` range's host ms, its span on the device, and the device
   time of the kernels launched inside it); then holds each kernel
   against its plain version at every shape the main path gave it.
4. Card against CPU: ``grid_instance(96, 96, seed=1)`` solved on both.
   Labels must be equal and objective / lower bound within 1e-5 relative;
   if the labels differ, the first round where the runs part is printed.
5. LM serving at full width: gemma2-9b (all 42 layers, random bf16
   weights from a seed). The prefill step on one (1, 8192) prompt through
   the flash kernel (counters zeroed just before, read just after: 42
   launches, 21 local + 21 global), then through ``backend="reference"``:
   logits finite, max |diff| / max |ref| <= 0.1 and greedy tokens agreeing
   at >= 85 % of positions. Decode against forward (last-position
   logits, same bound): 32 ``decode_step`` calls from an empty cache; and
   one step at context 8000 of an 8192-slot cache (filled by one prefill
   pass, so both the local layers' 4096 window and the global layers run
   as in real serving), with the same step one slot late (a planted
   fault) read under that bound. A float32 witness at 2 layers of full
   width holds four such steps within 1e-4 of forward with the same
   greedy tokens and must catch the planted fault. Then 16 timed and 4
   profiled decode steps at that context, and the serving loop
   (``launch/serve.py``) at full width with a few requests at contexts
   of 24 tokens (a smoke, not a measure). Prints prefill seconds and
   tokens/s, decode steps/s at context 8000, peak device memory, host
   syncs per prefill and per decode step, and the device time by kernel
   of a profiled prefill and of the profiled decode steps.

6. The dense data path and the modes p, pd+ and d. (a) The instance and
   config of ``examples/quickstart.py`` (200 nodes padded to 256: dense
   under ``auto``) through ``api.solve`` in all four modes on the card,
   with the kernels and with ``backend="reference"`` (equal), and on the
   CPU (labels equal, objective and lower bound within 1e-5 relative).
   (b) ``grid_instance(128, 128)`` (16 384 nodes, (N, N) matrices of
   about 1 GB) solved with ``graph_impl="dense"`` and ``"sparse"`` in
   modes pd and d: labels, rounds and histories equal, objective and
   lower bound within 1e-4 relative; wall time (median of 3 after a
   warm-up), host syncs and peak memory of each, and the device time by
   phase of one profiled dense pd solve. (c) Lemma 4 on (b)'s round 0:
   ``contract_matmul(adjacency_dense(inst'), mapping, n_new)`` against
   ``adjacency_dense`` of the contracted instance within 1e-5 of its
   largest entry, two product launches and four split passes, then the
   kernel against its plain version and cuBLAS at that shape.

Prints the ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Writes the
full record to ``chiprun_out/chip_smoke.json``.

``--rehearse`` runs the same phases on the CPU at small sizes (a 20×20
main-path grid, a 17×17 card-vs-CPU grid, attention at S <= 128, a
2-layer gemma2 of width 64, contraction cases up to (513, 100), a 20×20
dense-path grid), with each kernel wrapper running its plain version, to
find wrong paths and shapes before a run on the card; it prints no result
and exits 3.

The smoke drives one card: it keeps only the first of the visible devices.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

# one card: the first visible one, numbered as nvidia-smi numbers it
os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
CARD = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
os.environ["CUDA_VISIBLE_DEVICES"] = CARD

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import contraction, graph, solver  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.contract_matmul import ops as cm_ops  # noqa: E402
from repro_torch.kernels.contract_matmul.ref import (  # noqa: E402
    contract_matmul_ref, full_fp32, one_hot,
)
from repro_torch.kernels.cycle_intersect import ops as isect_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.chunked import chunked_attention  # noqa: E402,E501
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref  # noqa: E402,E501
from repro_torch.kernels.triangle_mp import ops as sweep_ops  # noqa: E402
from repro_torch.kernels.triangle_mp.ref import (  # noqa: E402
    mp_phase_ref, mp_plan, mp_sweep_ref,
)
from repro_torch.sparse import segment_ops  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12         # H100 SXM TF32 tensor cores, dense
FLASH_TOL = dict(atol=1e-2, rtol=1e-2)
LOGITS_REL_TOL = 0.1            # max |diff| / max |ref| of LM logits
GREEDY_AGREE_MIN = 0.85         # kernel vs plain prefill, random weights
DECODE_F32_REL_TOL = 1e-4       # decode vs forward, float32, 2 layers
# contract_matmul vs plain, max |diff| / max |ref|: 3xTF32 (float32
# accurate) summed in another order; a single TF32 product would sit near
# 1e-4 and fail it
CONTRACT_REL_TOL = 1e-5
DENSE_REL_TOL = 1e-4            # dense vs sparse objective / lower bound
CPU_REL_TOL = 1e-5              # card vs CPU objective / lower bound
SWEEP_FLOPS = 50                # per triangle: 6 steps x ~8 ops
MP_ITERS = 5                    # SolverConfig().mp_iters
# the fused MP phase's kernels; the sweep alone is triangle_mp_sweep_kernel
PHASE_SYMBOLS = ("triangle_mp_phase_kernel", "triangle_mp_pass_kernel",
                 "triangle_mp_land_kernel")
REPS = 20
DEV = torch.device("cuda")      # --rehearse switches to the CPU
CARD_NAME = "rehearsal on the CPU"  # nvidia-smi's name and power limit
GRIDS = {"card": ((512, 1024), (96, 96)),    # (main path, card vs CPU)
         "rehearse": ((20, 20), (17, 17))}
# phase 2 contraction cases (N old nodes, M clusters) and phase 6's grid
CONTRACT_CASES = {
    "card": [(8, 3), (64, 17), (256, 256), (300, 77), (513, 100),
             (2048, 512), (8192, 2048)],
    "rehearse": [(8, 3), (64, 17), (256, 256), (300, 77), (513, 100)]}
DENSE_GRID = {"card": (128, 128), "rehearse": (20, 20)}
# phase 2 MP phase cases (T, E, valid rows, label): the solver's T with
# few valid rows (one block), a ragged T, and mp_sweep_1m's T = 2^20 (a
# launch per pass)
PHASE_CASES = {
    "card": [(1024, 2_610_185, 128, "T 1024, few valid"),
             (2048, 2_610_185, 256, "T 2048, few valid"),
             (1999, 100_000, 1500, "ragged T"),
             (1 << 20, 1 << 22, 1 << 20, "T 2^20, all valid")],
    "rehearse": [(1024, 5000, 128, "T 1024, few valid"),
                 (2048, 5000, 256, "T 2048, few valid"),
                 (1999, 5000, 1500, "ragged T"),
                 (4099, 20000, 4099, "T 4099, all valid")]}
PORT = str(ROOT / "src" / "repro_torch")

KERNELS = {
    "triangle_mp": dict(
        source="src/repro_torch/csrc/triangle_mp.cu",
        replaces="src/repro/kernels/triangle_mp/kernel.py:51"),
    "cycle_intersect": dict(
        source="src/repro_torch/csrc/cycle_intersect.cu",
        replaces="src/repro/kernels/cycle_intersect/kernel.py:98"),
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:122"),
    "contract_matmul": dict(
        source="src/repro_torch/csrc/contract_matmul.cu",
        replaces="src/repro/kernels/contract_matmul/kernel.py:58"),
}
# flash cases: (label, B, Hq, Hkv, S, D, window, softcap); all causal.
# The first is the main path's head row (gemma2-9b's global layers).
# The next four probe the kernel's tiling (BQ = 128 query rows, BK = 80
# keys at D = 256): a window narrower than a key tile, S one row past a
# query block, Hq = Hkv, and D = 96 (one and a half swizzle atoms) with a
# window. The last is the head row without its softcap: what the softcap
# costs, and the same function as the library call.
FLASH_CASES = {
    "card": [("gemma2 global", 1, 16, 8, 8192, 256, None, 50.0),
             ("gemma2 local", 1, 16, 8, 8192, 256, 4096, 50.0),
             ("phi3-mini", 1, 32, 32, 4096, 96, None, None),
             ("granite-34b", 1, 48, 1, 4096, 128, None, None),
             ("ragged S", 2, 16, 8, 1000, 256, 300, 50.0),
             ("S = 1", 1, 16, 8, 1, 256, None, 50.0),
             ("window < BK", 1, 16, 8, 1000, 256, 17, 50.0),
             ("S = BQ + 1", 1, 16, 8, 129, 256, None, 50.0),
             ("Hq = Hkv", 1, 16, 16, 2048, 256, None, 50.0),
             ("D 96 window", 1, 32, 32, 2048, 96, 512, None),
             ("gemma2 global, no softcap", 1, 16, 8, 8192, 256, None,
              None)],
    "rehearse": [("gemma2 global", 1, 16, 8, 128, 256, None, 50.0),
                 ("gemma2 local", 1, 16, 8, 128, 256, 64, 50.0),
                 ("phi3-mini", 1, 32, 32, 64, 96, None, None),
                 ("granite-34b", 1, 48, 1, 64, 128, None, None),
                 ("ragged S", 2, 16, 8, 37, 256, 9, 50.0),
                 ("S = 1", 1, 16, 8, 1, 256, None, 50.0),
                 ("window < BK", 1, 16, 8, 100, 256, 17, 50.0),
                 ("S = BQ + 1", 1, 16, 8, 129, 256, None, 50.0),
                 ("Hq = Hkv", 1, 16, 16, 128, 256, None, 50.0),
                 ("D 96 window", 1, 32, 32, 128, 96, 40, None),
                 ("gemma2 global, no softcap", 1, 16, 8, 128, 256, None,
                  None)],
}
# phase 5: (prefill S, short decode prompt, long decode context P0 (a
# cache of S slots filled to P0 > the local window), timed decode steps
# there, launch/serve.py flags)
LM_RUN = {"card": (8192, 32, 8000, 16, ["--reduce", "1", "--batch", "4",
                                        "--prompt-len", "16", "--gen", "8",
                                        "--requests", "6"]),
          "rehearse": (48, 12, 36, 4, ["--reduce", "16", "--batch", "2",
                                       "--prompt-len", "6", "--gen", "3",
                                       "--requests", "3"])}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", CARD, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"{torch.cuda.get_device_name(0)}, power limit not readable"


def sync():
    if DEV.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps=REPS, warmup=3) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    if DEV.type != "cuda":          # rehearsal: no device time exists
        return float("nan")
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Kernel checks and timings
# ---------------------------------------------------------------------------

def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sweep_case(T: int, gen) -> dict:
    """The sweep alone (the TPU kernel's direct counterpart) against its
    plain version, bitwise; its device µs by profile and share of its
    bytes bound."""
    x = torch.randn(T, 3, device=DEV, generator=gen) * 3.0
    n0 = sweep_ops.launches
    got = sweep_ops.mp_sweep(x)
    want = mp_sweep_ref(x)
    sync()
    check(sweep_ops.launches == n0 + (DEV.type == "cuda"),
          f"triangle_mp sweep T={T}: no launch")
    bitwise = bool(torch.equal(got.view(torch.int32),
                               want.view(torch.int32)))
    err = float((got - want).abs().max()) if T else 0.0
    check(bitwise, f"triangle_mp sweep T={T}: not bitwise equal (max err "
          f"{err})")
    bound_ms, by = bound(24 * T, SWEEP_FLOPS * T)

    def call():
        return sweep_ops.mp_sweep(x)
    sym = ("triangle_mp_sweep_kernel",)
    dev_us = device_us(call, symbols=sym, flush=True)
    warm_us = device_us(call, symbols=sym)
    return dict(label="sweep", shape=[T, 3], bitwise=bitwise,
                max_abs_err=err, kernel_ms=cuda_ms(call),
                plain_ms=cuda_ms(lambda: mp_sweep_ref(x)),
                device_us=dev_us, l2_warm_device_us=warm_us,
                library_ms=None, bound_ms=bound_ms, bound_by=by,
                bound_share=(bound_ms * 1e3 / dev_us if dev_us else None))


def phase_inputs(T: int, E: int, n_valid: int, gen):
    """A synthetic MP phase: ``n_valid`` valid rows spread over T, their
    edge ids drawn from a pool of 1.5 ids a valid triangle (so edges are
    shared by several triangles), invalid rows zeroed; random costs over
    E edges, one in 16 invalid."""
    pool = torch.randperm(E, generator=gen, device=DEV)[
        :max(3, 3 * n_valid // 2)].to(torch.int32)
    tri = pool[torch.randint(0, pool.numel(), (T, 3), generator=gen,
                             device=DEV)]
    valid = torch.zeros(T, dtype=torch.bool, device=DEV)
    valid[torch.randperm(T, generator=gen, device=DEV)[:n_valid]] = True
    tri = torch.where(valid[:, None], tri, torch.zeros_like(tri))
    cost = torch.randn(E, generator=gen, device=DEV) * 3.0
    ev = torch.rand(E, generator=gen, device=DEV) >= 1 / 16
    return cost, ev, tri, valid


def phase_work(cost, tri, valid, iters: int) -> tuple[int, int]:
    """Bytes and float ops the phase kernel needs on these inputs: the
    row flags, the valid rows' edge ids, the sorted keys and entries of
    their slots and the touched edges' costs read once, the valid rows'
    costs and the touched edges' c_rep written once; each pass a slot
    adds its segment's entries (+3: c + Σ, / deg, + t) and the sweep
    takes ~50, the landing adds each segment once more."""
    plan = mp_plan(cost, tri, valid)
    nv = int(valid.sum())
    seg = plan.length[plan.length > 0].long()
    U = int(seg.numel())
    slot_adds = int((seg * seg).sum())      # Σ over valid slots of deg
    T = tri.shape[0]
    bytes_moved = T + 12 * nv + 3 * nv * (4 + 8) + 4 * U + 12 * nv + 4 * U
    ops = iters * (slot_adds + 9 * nv + SWEEP_FLOPS * nv) \
        + int(seg.sum()) + U
    return bytes_moved, ops


def phase_case(T: int, E: int, n_valid: int, gen, label: str,
               iters: int = MP_ITERS) -> dict:
    """The fused MP phase (``mp_phase``) against ``mp_phase_ref`` on the
    same inputs: t_cost, c_rep and lb bitwise equal; its launches; kernel
    ms of the whole call (plan, kernel, landing buffer, lower bound) and
    of the plain version; profiled device µs of the phase kernels per
    call and of the whole call; the kernels' bound from the plan's reads
    and writes."""
    cost, ev, tri, valid = phase_inputs(T, E, n_valid, gen)
    fused = T <= sweep_ops.FUSED_MAX_T
    want_launches = (1 if fused else iters + 1) * (DEV.type == "cuda")
    n0 = sweep_ops.launches
    got = sweep_ops.mp_phase(cost, ev, tri, valid, iters)
    want = mp_phase_ref(cost, ev, tri, valid, iters)
    sync()
    check(sweep_ops.launches == n0 + want_launches,
          f"triangle_mp phase T={T}: {sweep_ops.launches - n0} launches, "
          f"want {want_launches}")
    same = [torch.equal(g.view(torch.int32), w.view(torch.int32))
            for g, w in zip(got, want)]
    err = max(float((g - w).abs().max()) if g.numel() else 0.0
              for g, w in zip(got, want))
    check(all(same), f"triangle_mp phase T={T}: (t_cost, c_rep, lb) "
          f"bitwise equal {same} (max err {err})")
    bytes_moved, ops = phase_work(cost, tri, valid, iters)
    bound_ms, by = bound(bytes_moved, ops)

    def call():
        return sweep_ops.mp_phase(cost, ev, tri, valid, iters)
    kernel_us = device_us(call, symbols=PHASE_SYMBOLS)
    return dict(label=label, shape=[T, 3], edges=E, n_valid=n_valid,
                iters=iters, route="one launch" if fused else
                "a launch per pass + landing", launches=want_launches,
                bitwise=all(same), max_abs_err=err,
                kernel_ms=cuda_ms(call),
                plain_ms=cuda_ms(lambda: mp_phase_ref(cost, ev, tri, valid,
                                                      iters)),
                device_us=kernel_us, call_device_us=device_us(call),
                library_ms=None, bound_ms=bound_ms, bound_by=by,
                bound_share=(bound_ms * 1e3 / kernel_us if kernel_us
                             else None))


def sorted_rows(R: int, W: int, n: int, gen) -> torch.Tensor:
    """(R, W) rows of sorted ids < n with random degree, padded with the
    sentinel n (the CSR window layout); about a tenth of the rows empty."""
    x = torch.sort(torch.randint(0, n, (R, W), device=DEV,
                                 dtype=torch.int32, generator=gen), 1).values
    deg = torch.randint(0, W + 1, (R, 1), device=DEV, generator=gen)
    deg = torch.where(torch.rand(R, 1, device=DEV, generator=gen) < 0.1,
                      torch.zeros_like(deg), deg)
    ar = torch.arange(W, device=DEV)
    return torch.where(ar < deg, x, torch.full_like(x, n)).contiguous()


def intersect_case(R: int, W: int, Wj: int, gen, ci=None) -> dict:
    n = 2 * max(W, Wj) + 8
    ci = sorted_rows(R, W, n, gen) if ci is None else ci
    cj = sorted_rows(R, Wj, n, gen)
    n0 = isect_ops.launches
    got = isect_ops.intersect_rows(ci, cj)
    want = intersect_rows_ref(ci, cj)
    sync()
    check(isect_ops.launches == n0 + (DEV.type == "cuda"),
          f"cycle_intersect {R, W, Wj}: no launch")
    equal = bool(torch.equal(got, want))
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(equal, f"cycle_intersect {(R, W, Wj)}: not equal (max err {err})")
    bytes_moved = 4 * (2 * R * W + R * Wj)
    # data-dependent work: one upper-bound search of ceil(log2(Wj + 1))
    # compares per element (counted as 2 ops each: compare + select)
    ops = 2 * R * W * int(np.ceil(np.log2(Wj + 1)))
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3

    def kernel():
        isect_ops.intersect_rows(ci, cj)

    def library():      # the search half only: no hit test, no -1
        torch.searchsorted(cj, ci, right=True)

    # one call's CUDA-event time on an idle card is mostly host time, so
    # each side also gets host µs per call (1 000 calls, one synchronise)
    # and device µs per call (profiled)
    return dict(shape=[[R, W], [R, Wj]], equal=equal, max_abs_err=err,
                matches=int((got >= 0).sum()),
                kernel_ms=cuda_ms(kernel),
                plain_ms=cuda_ms(lambda: intersect_rows_ref(ci, cj)),
                library_ms=cuda_ms(library), bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                host_us=host_us(kernel), device_us=device_us(kernel),
                library_host_us=host_us(library),
                library_device_us=device_us(library))


def host_us(fn, n: int = 1000) -> float:
    """Host microseconds per call of ``fn``: ``n`` calls, then one
    synchronise (a call whose device work outlasts its host work is
    timed by the device). A rehearsal makes 3 calls."""
    if DEV.type != "cuda":
        n = min(n, 3)
    sync()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter_ns() - t0) / n / 1e3


def device_us(fn, n: int = 20, symbols=None,
              flush: bool = False) -> float | None:
    """Device microseconds per call of ``fn``: the device-side events of
    ``n`` calls under torch.profiler (those of kernels whose name holds
    one of ``symbols``, if given), summed, over ``n``. ``flush`` writes a
    128 MB buffer before each call, so the call finds its inputs in
    device memory and not in L2 (pass ``symbols`` with it, or the flush
    is counted too)."""
    if DEV.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # larger than the card's 50 MB L2; freed on return, so it is in no
    # later peak-memory reading
    junk = torch.empty(1 << 25 if flush else 0, device=DEV)
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if flush:
                junk.zero_()
            fn()
        sync()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and
             (symbols is None or any(k in e.key for k in symbols)))
    return us / n


def launch_breakdown(R: int = 32, W: int = 128, Wj: int = 128,
                     n: int = 1000) -> dict:
    """Host microseconds of each step of the ``cycle_intersect`` launch
    path at the main-path head shape, each step alone over ``n`` calls:
    ``before`` replays the steps of the former wrapper (a ``torch.cuda.device``
    context, ``torch.cuda.current_stream``, unconditional ``.to`` /
    ``.contiguous``, ``torch.empty`` with keywords) around this kernel's
    entry point, ``after`` the steps of ``isect_ops.intersect_rows``; then
    the whole calls of both and of ``torch.searchsorted``."""
    if DEV.type != "cuda":
        return {}
    gen = torch.Generator(device=DEV).manual_seed(1)
    ci = sorted_rows(R, W, 2 * max(W, Wj) + 8, gen)
    cj = sorted_rows(R, Wj, 2 * max(W, Wj) + 8, gen)
    isect_ops.intersect_rows(ci, cj)                # binds the entry point
    launcher = isect_ops._launch
    index = ci.get_device()
    # the unpacked entry point: the former wrapper's eight ctypes arguments
    fn = launcher._lib.cycle_intersect_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(ci)
    a0, b0, o0 = ci.data_ptr(), cj.data_ptr(), out.data_ptr()
    counts = Counter()

    def old_checks():
        if ci.device != cj.device or ci.device.type == "cpu" \
                or ci.device.type != "cuda":
            raise AssertionError
        if ci.dim() != 2 or cj.dim() != 2 or ci.shape[0] != cj.shape[0]:
            raise AssertionError
        r, w = ci.shape
        return r, w, cj.shape[1]

    def old_convert():
        return (ci.to(torch.int32).contiguous(),
                cj.to(torch.int32).contiguous())

    def old_context():
        with torch.cuda.device(ci.device):
            pass

    def old_stream():
        return torch.cuda.current_stream(ci.device).cuda_stream

    stream = old_stream()

    def old_call():
        old_checks()
        a, b = old_convert()
        o = torch.empty((R, W), dtype=torch.int32, device=a.device)
        with torch.cuda.device(a.device):
            st = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a.data_ptr(), b.data_ptr(), o.data_ptr(), R, W, Wj,
                    index, st)
            if rc:
                raise AssertionError(rc)
        counts[(R, W, Wj)] += 1
        return o

    def new_checks():
        idx = ci.get_device()
        if idx < 0 or cj.get_device() != idx:
            raise AssertionError
        r, w = ci.shape
        r2, wj = cj.shape
        if r2 != r:
            raise AssertionError
        return r, w, wj

    def counters():
        counts[(R, W, Wj)] += 1

    steps = {
        "before": dict(
            checks=old_checks, to_int32_contiguous=old_convert,
            empty=lambda: torch.empty((R, W), dtype=torch.int32,
                                      device=ci.device),
            device_context=old_context, current_stream=old_stream,
            ctypes_launch=lambda: fn(a0, b0, o0, R, W, Wj, index, stream),
            counters=counters),
        "after": dict(
            checks=new_checks,
            int32_check=lambda: (ci.dtype is torch.int32
                                 and ci.is_contiguous(),
                                 cj.dtype is torch.int32
                                 and cj.is_contiguous()),
            empty_like=lambda: torch.empty_like(ci),
            raw_stream=lambda: torch._C._cuda_getCurrentRawStream(index),
            ctypes_launch=lambda: launcher(index, a0, b0, o0, R, W, Wj),
            counters=counters)}
    rec = {side: {k: host_us(f, n) for k, f in st.items()}
           for side, st in steps.items()}
    rec["before"]["sum"] = sum(rec["before"].values())
    rec["after"]["sum"] = sum(rec["after"].values())
    rec["before"]["call"] = host_us(old_call, n)
    rec["after"]["call"] = host_us(
        lambda: isect_ops.intersect_rows(ci, cj), n)
    rec["searchsorted_call"] = host_us(
        lambda: torch.searchsorted(cj, ci, right=True), n)
    rec["shape"] = [[R, W], [R, Wj]]
    return rec


def visible_pairs(S: int, window) -> int:
    """(q, k) pairs a causal row set of length S sees, with a window."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_case(label, B, Hq, Hkv, S, D, window, softcap, gen) -> dict:
    def rand(h, scale):
        return (torch.randn(B, h, S, D, device=DEV, generator=gen)
                * scale).to(torch.bfloat16)
    q, k, v = rand(Hq, 2.0), rand(Hkv, 1.0), rand(Hkv, 1.0)
    kw = dict(causal=True, window=window, softcap=softcap)
    n0 = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, **kw)
    want = chunked_attention(q, k, v, **kw)
    sync()
    check(flash_ops.launches == n0 + (DEV.type == "cuda"),
          f"flash_attention {label}: no launch")
    check(torch.equal(got, flash_ops.flash_attention(q, k, v, **kw)),
          f"flash_attention {label}: two launches gave different bits")
    check(got.shape == q.shape and got.dtype == q.dtype
          and bool(torch.isfinite(got).all()),
          f"flash_attention {label}: bad output")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    bad = int((diff > FLASH_TOL["atol"]
               + FLASH_TOL["rtol"] * want.float().abs()).sum())
    check(bad == 0, f"flash_attention {label}: {bad} elements outside "
          f"atol/rtol {FLASH_TOL} (max err {err})")
    flops = 4 * D * visible_pairs(S, window) * B * Hq
    bytes_moved = 2 * D * S * B * (2 * Hq + 2 * Hkv)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_OPS_PER_S * 1e3
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():      # softcap and window off: the nearest one call
        sdpa(q, k, v, is_causal=True, enable_gqa=Hq != Hkv)

    kernel_ms = cuda_ms(lambda: flash_ops.flash_attention(q, k, v, **kw))
    bound_ms = max(t_bytes, t_ops)
    top = profile_device(library).get("top_device_kernels", [])
    return dict(label=label, shape=[B, Hq, Hkv, S, D], window=window,
                softcap=softcap, max_abs_err=err, kernel_ms=kernel_ms,
                plain_ms=cuda_ms(lambda: chunked_attention(q, k, v, **kw),
                                 reps=5, warmup=1),
                library_ms=cuda_ms(library),
                # the library call does every causal pair, window or not
                library_pairs_ratio=visible_pairs(S, None)
                / visible_pairs(S, window),
                library_kernel=top[0]["name"] if top else None,
                bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                tflop_per_s=flops / kernel_ms / 1e9,
                bound_share=bound_ms / kernel_ms)


def contract_case(N: int, M: int, gen, A=None, f=None, label=None) -> dict:
    """``contract_matmul`` (two launches) against its plain version, on
    random symmetric A and a random mapping unless given; times the
    wrapper, its two products alone on a prebuilt K, the plain version and
    the same two products through cuBLAS (TF32 off)."""
    if A is None:
        A = torch.randn(N, N, device=DEV, generator=gen)
        A = (A + A.T) / 2
        f = torch.randint(0, M, (N,), device=DEV, generator=gen,
                          dtype=torch.int32)
    n0, s0 = cm_ops.launches, cm_ops.split_launches
    if DEV.type == "cuda":
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    got = cm_ops.contract_matmul(A, f, M)
    sync()
    peak = torch.cuda.max_memory_allocated() if DEV.type == "cuda" else 0
    extra = peak - base if DEV.type == "cuda" else 0
    want = contract_matmul_ref(A, f, M)
    sync()
    on_card = DEV.type == "cuda"
    check(cm_ops.launches == n0 + 2 * on_card
          and cm_ops.split_launches == s0 + 4 * on_card,
          f"contract_matmul {N, M}: not two product launches and four "
          f"split passes")
    check(got.shape == (M, M) and bool(torch.isfinite(got).all()),
          f"contract_matmul {N, M}: bad output")
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    check(rel <= CONTRACT_REL_TOL, f"contract_matmul {N, M}: max |diff| / "
          f"max |ref| {rel} > {CONTRACT_REL_TOL}")
    check(not bool(got.diagonal().any()),
          f"contract_matmul {N, M}: diagonal not dropped")
    del got, want
    K = one_hot(f, M)
    ops = 2 * N * N * M + 2 * M * N * M
    bytes_moved = 4 * N * N + 4 * N + 4 * M * M
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    # the kernel's float32-accurate work is three TF32 products (3xTF32)
    t_ops = 3 * ops / TF32_OPS_PER_S * 1e3
    reps, warm = (5, 1) if ops > 1e12 else (REPS, 3)

    def products():
        cm_ops.matmul(K.T, cm_ops.matmul(A, K), drop_diag=True)

    def library():      # the same two products through cuBLAS SGEMM
        with full_fp32():
            torch.matmul(K.T, torch.matmul(A, K))

    kernel_ms = cuda_ms(lambda: cm_ops.contract_matmul(A, f, M), reps, warm)
    bound_ms = max(t_bytes, t_ops)
    return dict(label=label, shape=[N, M], max_abs_err=err, rel_err=rel,
                kernel_ms=kernel_ms, products_ms=cuda_ms(products, reps,
                                                         warm),
                plain_ms=cuda_ms(lambda: contract_matmul_ref(A, f, M), reps,
                                 warm),
                library_ms=cuda_ms(library, reps, warm),
                bound_ms=bound_ms,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                fp32_pipe_bound_ms=max(t_bytes,
                                       ops / FP32_OPS_PER_S * 1e3),
                bound_share=bound_ms / kernel_ms,
                tflop_per_s=ops / kernel_ms / 1e9,
                peak_bytes=peak, scratch_peak_bytes=extra)


def phase_kernels(gen, small: bool) -> dict:
    cases = {"triangle_mp": [], "cycle_intersect": [], "flash_attention": [],
             "contract_matmul": []}
    big = 65536 if not small else 512
    for T in ((1 << 20, 1_000_003) if not small else (4096, 4099)):
        cases["triangle_mp"].append(sweep_case(T, gen))
    for T, E, n_valid, label in PHASE_CASES["rehearse" if small
                                            else "card"]:
        cases["triangle_mp"].append(phase_case(T, E, n_valid, gen, label))
    for R, W, Wj in [(256, 16, 16), (256, 128, 128), (1024, 128, 128),
                     (1024, 4, 128), (300, 37, 129), (big, 128, 128),
                     (9, 1, 1), (8, 1, 20000)]:
        cases["cycle_intersect"].append(intersect_case(R, W, Wj, gen))
    # an unsorted ci (the chord test's fan) and all-empty rows
    fan = torch.randint(0, 264, (1024, 4), device=DEV, dtype=torch.int32,
                        generator=gen)
    cases["cycle_intersect"].append(intersect_case(1024, 4, 128, gen,
                                                   ci=fan))
    empty = torch.full((512, 64), 136, device=DEV, dtype=torch.int32)
    cases["cycle_intersect"].append(intersect_case(512, 64, 64, gen,
                                                   ci=empty))
    for c in FLASH_CASES["rehearse" if small else "card"]:
        cases["flash_attention"].append(flash_case(*c, gen))
    for N, M in CONTRACT_CASES["rehearse" if small else "card"]:
        cases["contract_matmul"].append(contract_case(N, M, gen))
    for name, rows in cases.items():
        for c in rows:
            log_case(name, c)
    cases["launch_breakdown"] = launch_breakdown()
    if cases["launch_breakdown"]:
        bd = cases["launch_breakdown"]
        log(f"  cycle_intersect launch path at {bd['shape']}, host us per "
            f"step: before {bd['before']}, after {bd['after']}, "
            f"searchsorted call {bd['searchsorted_call']} [{CARD_NAME}]")
    return cases


def log_case(name: str, c: dict):
    lib = "" if c["library_ms"] is None else \
        f", library {c['library_ms']:.4f} ms"
    rate = "" if "tflop_per_s" not in c else \
        f" ({c['tflop_per_s']:.1f} TFLOP/s, bound share " \
        f"{c['bound_share']:.3f})"
    more = ""
    if "fp32_pipe_bound_ms" in c:
        more = (f", FP32-pipe bound {c['fp32_pipe_bound_ms']:.5f} ms, "
                f"peak {c['peak_bytes']} B (scratch "
                f"{c['scratch_peak_bytes']} B)")
    if "host_us" in c:
        more = (f"; host/device us per call: kernel {c['host_us']:.2f} / "
                f"{c['device_us']}, searchsorted "
                f"{c['library_host_us']:.2f} / {c['library_device_us']}")
    elif "device_us" in c:
        more = (f"; profiled device us per call {c['device_us']}, share of "
                f"bound {c['bound_share']}")
        if "l2_warm_device_us" in c:
            more += (f" (inputs flushed from L2; {c['l2_warm_device_us']} us "
                     f"with them in L2)")
        if "call_device_us" in c:
            more += (f"; {c['launches']} launches ({c['route']}), "
                     f"{c['n_valid']} valid rows, E {c['edges']}, whole "
                     f"call {c['call_device_us']} device us")
    log(f"  {name} {c.get('label') or ''} {c['shape']}: kernel "
        f"{c['kernel_ms']:.4f} ms{rate}, plain {c['plain_ms']:.4f} ms"
        f"{lib}, bound {c['bound_ms']:.5f} ms, err "
        f"{c['max_abs_err']}{more} [{CARD_NAME}]")


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def reset_counters():
    for ops in (sweep_ops, isect_ops, flash_ops, cm_ops):
        ops.launches = 0
        ops.shapes.clear()
    cm_ops.split_launches = 0


def all_launches() -> dict:
    return {"triangle_mp": sweep_ops.launches,
            "cycle_intersect": isect_ops.launches,
            "flash_attention": flash_ops.launches,
            "contract_matmul": cm_ops.launches}


def phase_launches(shapes: dict, iters: int = MP_ITERS) -> int:
    """triangle_mp launches that MP phases of these T counts make."""
    return sum(n * (1 if T <= sweep_ops.FUSED_MAX_T else iters + 1)
               for T, n in shapes.items())


@contextlib.contextmanager
def count_calls(module, name: str):
    """Count calls of ``module.name`` made through the module's attribute
    while the block runs; yields a one-element list holding the count."""
    fn = getattr(module, name)
    count = [0]

    def counted(*a, **kw):
        count[0] += 1
        return fn(*a, **kw)
    setattr(module, name, counted)
    try:
        yield count
    finally:
        setattr(module, name, fn)


def timed_solve(inst, **kw):
    sync()
    t0 = time.perf_counter()
    res = api.solve(inst, device=DEV, **kw)
    sync()
    return res, time.perf_counter() - t0


def host(res) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in res._asdict().items()}


def same_result(a: dict, b: dict) -> list:
    return [k for k in a if not np.array_equal(a[k], b[k])]


def check_solution(inst, r: dict, what: str):
    labels = r["labels"]
    rounds = int(r["rounds"])
    k = int(r["n_clusters"][rounds - 1])
    check(np.isfinite(r["objective"]) and np.isfinite(r["lower_bound"]),
          f"{what}: non-finite objective/lower bound")
    check(float(r["lower_bound"]) <= float(r["objective"]) + 1e-3,
          f"{what}: lower bound {r['lower_bound']} > objective "
          f"{r['objective']}")
    check(labels.min() == 0 and labels.max() == k - 1
          and len(np.unique(labels)) == k,
          f"{what}: labels are not a partition into {k} clusters")
    # independent recount of the objective on the host, in float64
    u = inst.u.cpu().numpy()
    v = inst.v.cpu().numpy()
    ev = inst.edge_valid.cpu().numpy()
    c = inst.cost.cpu().numpy().astype(np.float64)
    obj64 = float(c[ev & (labels[u] != labels[v])].sum())
    rel = abs(obj64 - float(r["objective"])) / max(1.0, abs(obj64))
    check(rel < 1e-4, f"{what}: objective {r['objective']} vs host recount "
          f"{obj64}")
    return obj64


def count_syncs(fn) -> Counter:
    """Synchronising CUDA calls during ``fn``, as torch's sync debug mode
    reports them, by the innermost function of the port that made each
    (by the innermost frame where no function of the port is on the
    stack)."""
    sites = Counter()
    if DEV.type != "cuda":
        fn()
        return sites

    def note(message, *_):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if not f.filename.endswith("warnings.py")]
        own = [f for f in stack if f.filename.startswith(PORT)]
        f = own[-1] if own else stack[-1]
        where = f"{Path(f.filename).name}:{f.name}" if own else \
            f"outside the port, {Path(f.filename).name}:{f.lineno}"
        sites[where] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sync()
    return sites


def profile_solve(inst, **kw) -> dict:
    """One solve (the main path's unless ``kw`` says otherwise) under
    torch.profiler: device busy time (the sum of the device-side kernel and
    copy events), each round phase's host and device milliseconds (the
    solver's ``repro.*`` ranges, summed over rounds: ``device_ms`` is the
    range's span on the device, which also covers idle gaps and earlier
    work still running; ``device_busy_ms`` sums the device time of the
    kernels and copies launched inside the range), device time per
    launch of each hand kernel, and the kernels that take the most device
    time."""
    if DEV.type != "cuda":
        return {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        api.solve(inst, device=DEV, **kw)
        sync()
        wall = time.perf_counter() - t0
    phases = {}
    by_kernel = {}
    for e in prof.events():
        dur = e.time_range.elapsed_us()
        if e.key.startswith("repro."):
            side = "device_ms" if e.device_type == DeviceType.CUDA \
                else "host_ms"
            ph = phases.setdefault(e.key, {"host_ms": 0.0, "device_ms": 0.0,
                                           "device_busy_ms": 0.0})
            ph[side] += dur / 1e3
            if side == "host_ms":       # kernels launched inside the range
                ph["device_busy_ms"] += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            n, us = by_kernel.get(e.key, (0, 0.0))
            by_kernel[e.key] = (n + 1, us + dur)
    busy_us = sum(us for _, us in by_kernel.values())
    kern = {}
    for name, syms in (("triangle_mp", PHASE_SYMBOLS),
                       ("cycle_intersect", ("cycle_intersect_kernel",))):
        mine = [v for k, v in by_kernel.items()
                if any(sym in k for sym in syms)]
        n = sum(c for c, _ in mine)
        us = sum(t for _, t in mine)
        kern[name] = dict(launches=n, device_us_total=us,
                          device_us_per_launch=us / n if n else None)
    top = sorted(by_kernel.items(), key=lambda kv: kv[1][1],
                 reverse=True)[:12]
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
                phases=phases, kernels=kern,
                device_launches=sum(c for c, _ in by_kernel.values()),
                top_device_kernels=[dict(name=k[:100], count=c,
                                         device_ms=us / 1e3)
                                    for k, (c, us) in top])


def grid_edges(h: int, w: int) -> int:
    """Edges of ``grid_instance(h, w)``: 4-neighbours and the long-range
    (0, 4), (4, 0), (3, 3) offsets."""
    return (h * (w - 1) + (h - 1) * w + h * (w - 4) + (h - 4) * w
            + (h - 3) * (w - 3))


def phase_main(h: int, w: int, max_neg: int) -> dict:
    E = grid_edges(h, w)
    t0 = time.perf_counter()
    inst = graph.grid_instance(h, w, seed=0, pad_edges=E + 4 * max_neg,
                               device=DEV)
    sync()
    log(f"  instance {h}x{w}: {inst.num_nodes} nodes, "
        f"{int(inst.edge_valid.sum())} edges (+{inst.num_edges - E} chord "
        f"slots), built in {time.perf_counter() - t0:.2f} s")

    if DEV.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counters()
    with count_calls(segment_ops, "sequential_sums") as per_edge:
        res, first_s = timed_solve(inst)             # the main path
    launches = all_launches()
    check(launches.pop("flash_attention") == 0
          and launches.pop("contract_matmul") == 0,
          "the sparse solve launched the attention or contraction kernel")
    main_shapes = {"triangle_mp": dict(sweep_ops.shapes),
                   "cycle_intersect": dict(isect_ops.shapes)}
    peak = torch.cuda.max_memory_allocated() if DEV.type == "cuda" else 0
    log(f"  default solve: {first_s:.3f} s (first call), launches "
        f"{launches}, MP phases {sum(main_shapes['triangle_mp'].values())}"
        f", per-edge MP sums {per_edge[0]}")
    check(DEV.type != "cuda" or all(n > 0 for n in launches.values()),
          f"main path did not launch every kernel: {launches}")
    want = phase_launches(main_shapes["triangle_mp"])
    check(DEV.type != "cuda" or launches["triangle_mp"] == want,
          f"main path: {launches['triangle_mp']} triangle_mp launches, "
          f"want {want} for its MP phases {main_shapes['triangle_mp']}")
    check(per_edge[0] == 0, f"the kernel solve ran the per-edge MP sums "
          f"{per_edge[0]} times")
    r = host(res)

    reset_counters()
    with count_calls(segment_ops, "sequential_sums") as per_edge_ref:
        ref, ref_s = timed_solve(inst, backend="reference")
    check(sweep_ops.launches == 0 and isect_ops.launches == 0,
          "backend='reference' launched a kernel")
    check(per_edge_ref[0] > 0, "backend='reference' did not run the "
          "per-edge MP")
    rr = host(ref)
    diff = same_result(r, rr)
    check(not diff, f"kernel solve != reference solve in {diff}")
    obj64 = check_solution(inst, r, "main path")

    walls = [timed_solve(inst)[1] for _ in range(3)]
    sync_sites = count_syncs(lambda: api.solve(inst, device=DEV))
    syncs = sum(sync_sites.values())
    check("segment_ops.py:segment_plan" not in sync_sites,
          f"the main path still syncs in segment_plan: {sync_sites}")
    prof = profile_solve(inst)
    out = dict(
        instance=dict(h=h, w=w, nodes=inst.num_nodes, edges=E,
                      pad_edges=inst.num_edges),
        rounds=int(r["rounds"]), objective=float(r["objective"]),
        objective_host_f64=obj64, lower_bound=float(r["lower_bound"]),
        n_contracted=r["n_contracted"].tolist(),
        n_clusters=r["n_clusters"].tolist(),
        wall_s_median=statistics.median(walls), wall_s=walls,
        first_call_s=first_s, reference_backend_s=ref_s,
        host_syncs=syncs, host_sync_sites=dict(sync_sites.most_common()),
        peak_bytes=peak, launches=launches, profile=prof,
        shapes={k: {str(s): n for s, n in v.items()}
                for k, v in main_shapes.items()})
    log(f"  wall {out['wall_s_median']:.3f} s (median of 3), rounds "
        f"{out['rounds']}, objective {out['objective']}, lower bound "
        f"{out['lower_bound']}, host syncs {syncs} "
        f"{out['host_sync_sites']}, peak {peak / 2**20:.1f} MiB")
    if prof:
        busy = prof["device_busy_ms"] / 1e3
        log(f"  profiled solve: device busy {busy:.3f} s of "
            f"{out['wall_s_median']:.3f} s wall (idle share "
            f"{1 - busy / out['wall_s_median']:.3f}), "
            f"{prof['device_launches']} device events; phases "
            f"{prof['phases']}; kernels {prof['kernels']}")
    out["main_shapes"] = main_shapes
    return out


def first_divergence(a: dict, b: dict) -> int | None:
    for i, (x, y) in enumerate(zip(a["n_contracted"], b["n_contracted"])):
        if x != y or a["n_clusters"][i] != b["n_clusters"][i]:
            return i
    return None


def phase_cpu(h: int, w: int) -> dict:
    gpu = host(api.solve(graph.grid_instance(h, w, seed=1, device=DEV),
                         device=DEV))
    cpu = host(api.solve(graph.grid_instance(h, w, seed=1, device="cpu"),
                         device="cpu"))
    labels_equal = bool(np.array_equal(gpu["labels"], cpu["labels"]))
    out = dict(instance=[h, w], labels_equal=labels_equal,
               rounds=[int(gpu["rounds"]), int(cpu["rounds"])],
               objective=[float(gpu["objective"]), float(cpu["objective"])],
               lower_bound=[float(gpu["lower_bound"]),
                            float(cpu["lower_bound"])],
               integer_fields_equal=not same_result(
                   {k: gpu[k] for k in ("labels", "rounds", "n_contracted",
                                        "n_clusters")},
                   {k: cpu[k] for k in ("labels", "rounds", "n_contracted",
                                        "n_clusters")}))
    if labels_equal:
        for f in ("objective", "lower_bound"):
            g, c = float(gpu[f]), float(cpu[f])
            check(abs(g - c) <= 1e-5 * max(1.0, abs(c)),
                  f"card vs CPU {f}: {g} vs {c}")
        check(out["integer_fields_equal"], "card vs CPU histories differ")
    else:
        out["first_divergent_round"] = first_divergence(gpu, cpu)
        log(f"  card and CPU labels differ; first divergent round "
            f"{out['first_divergent_round']}")
    log(f"  card vs CPU {h}x{w}: labels equal {labels_equal}, objective "
        f"{out['objective']}, lower bound {out['lower_bound']}")
    return out


def lm_config(rehearse: bool):
    """gemma2-9b at full width and depth on the card; a 2-layer width-64
    copy (window 16, so it masks at the rehearsal's S = 48) on the CPU."""
    arch = get_arch("gemma2-9b")
    if not rehearse:
        return arch
    return dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256, local_window=16))


def logits_diff(got, ref) -> dict:
    """max |got - ref|, max |ref|, their ratio, and the share of positions
    whose greedy token agrees."""
    err = float((got - ref).abs_().max())
    scale = float(ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    return dict(max_abs_err=err, max_abs_ref=scale, rel_err=err / scale,
                greedy_agreement=agree)


def logits_agree(got, ref, what: str) -> dict:
    """Finite logits within LOGITS_REL_TOL · max |ref| of ``ref``."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    out = logits_diff(got, ref)
    check(out["rel_err"] <= LOGITS_REL_TOL,
          f"{what}: max |diff| {out['max_abs_err']} > {LOGITS_REL_TOL} x "
          f"max |ref| {out['max_abs_ref']}")
    return out


def profile_device(fn) -> dict:
    """``fn`` under torch.profiler: host wall, device busy time (the sum
    of device-side events), the flash kernel's device time per launch,
    and the kernels that take the most device time."""
    if DEV.type != "cuda":
        return {}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_kernel.get(e.key, (0, 0.0))
            by_kernel[e.key] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_kernel.values())
    n = sum(c for k, (c, _) in by_kernel.items() if "flash_fwd_kernel" in k)
    us = sum(t for k, (_, t) in by_kernel.items() if "flash_fwd_kernel" in k)
    top = sorted(by_kernel.items(), key=lambda kv: kv[1][1],
                 reverse=True)[:12]
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_us / 1e3,
                idle_share=1 - busy_us / 1e3 / (wall * 1e3),
                device_events=sum(c for c, _ in by_kernel.values()),
                flash_attention=dict(launches=n, device_ms_total=us / 1e3,
                                     device_us_per_launch=us / n if n
                                     else None),
                top_device_kernels=[dict(name=k[:100], count=c,
                                         device_ms=t / 1e3)
                                    for k, (c, t) in top])


def fill_cache(cfg, params, tokens, cache, backend):
    """Write into ``cache`` what decoding ``tokens`` one at a time from
    position 0 leaves there (each layer's roped keys and its values), in
    one prefill pass with attention through ``backend``."""
    B, P = tokens.shape
    pos = torch.arange(P, dtype=torch.int32, device=DEV).expand(B, P)
    x = params["embed"][tokens].to(cfg.dtype)
    for i in range(cfg.n_layers):
        lp = tfm.layer_params(params, i)
        h = tfm.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        k, v = ((h @ lp[w].to(h.dtype)).view(B, P, cfg.n_kv_heads, cfg.hd)
                .transpose(1, 2) for w in ("wk", "wv"))
        cache["k"][i, :, :, :P] = tfm.rope(k, pos, cfg.rope_theta)
        cache["v"][i, :, :, :P] = v
        x = tfm.layer_fn(cfg, lp, x, pos, tfm.layer_window(cfg, i), backend)


def f32_decode_witness(cfg, tokens, P0: int, S: int) -> dict:
    """gemma2-9b's width in float32 at 2 layers (one local, one global):
    four decode steps after a context of P0 > window tokens against the
    forward logits at those positions (plain attention), within
    DECODE_F32_REL_TOL and the same greedy tokens; then a planted fault
    (the step one cache slot late, ``cache_len`` P0 + 1) must fail that
    gate."""
    cfg = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    params = tfm.init_params(cfg, torch.Generator(device=DEV).manual_seed(1),
                             DEV)
    n = 4
    hid = tfm.forward_hidden(cfg, params, tokens[:, :P0 + n],
                             backend="reference")[:, P0:]
    want = tfm.forward_logits_from_hidden(cfg, params, hid)
    cache = tfm.init_kv_cache(cfg, 1, S, DEV)
    fill_cache(cfg, params, tokens[:, :P0], cache, "reference")
    bad = {k: c.clone() for k, c in cache.items()}
    got = torch.stack([tfm.decode_step(cfg, params, tokens[:, P0 + t], cache,
                                       P0 + t)[0] for t in range(n)], 1)
    scale = float(want.abs().max())
    out = dict(layers=2, context=P0, steps=n,
               rel_err=float((got - want).abs().max()) / scale,
               argmax_equal=bool(torch.equal(got.argmax(-1),
                                             want.argmax(-1))))
    late, _ = tfm.decode_step(cfg, params, tokens[:, P0], bad, P0 + 1)
    out["planted_fault_rel_err"] = float((late - want[:, 0]).abs().max()) \
        / scale
    check(out["rel_err"] <= DECODE_F32_REL_TOL,
          f"f32 decode vs forward: rel {out['rel_err']} > "
          f"{DECODE_F32_REL_TOL}")
    check(out["argmax_equal"], "f32 decode vs forward: greedy tokens differ")
    check(out["planted_fault_rel_err"] > DECODE_F32_REL_TOL,
          f"f32 decode gate misses a cache write one slot late: rel "
          f"{out['planted_fault_rel_err']}")
    return out


def phase_lm(rehearse: bool) -> dict:
    arch = lm_config(rehearse)
    cfg = arch.cfg
    S, P, P0, n_steps, serve_flags = LM_RUN["rehearse" if rehearse
                                            else "card"]
    gen = torch.Generator(device=DEV).manual_seed(0)
    sync()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, gen, DEV)
    sync()
    init_s = time.perf_counter() - t0
    leaves = [t for k, t in params.items() if k != "layers"]
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       leaves + list(params["layers"].values()))
    log(f"  {cfg.name}: {cfg.n_layers} layers, {cfg.params_count} params, "
        f"{weight_bytes / 1e9:.2f} GB of weights, drawn in {init_s:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (1, S), device=DEV, generator=gen)
    prefill = arch.step_fn(arch.shapes["prefill_32k"])
    plain = arch.step_fn(arch.shapes["prefill_32k"], backend="reference")

    if DEV.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counters()
    sync()
    t0 = time.perf_counter()
    logits = prefill(params, tokens)                 # the main path
    sync()
    first_s = time.perf_counter() - t0
    launches = all_launches()
    shapes = {str(k): n for k, n in flash_ops.shapes.items()}
    peak = torch.cuda.max_memory_allocated() if DEV.type == "cuda" else 0
    log(f"  prefill (1, {S}): {first_s:.3f} s (first call), launches "
        f"{launches}, shapes {shapes}")
    check(tuple(logits.shape) == (1, S, cfg.vocab)
          and logits.dtype == torch.float32, "prefill: bad logits shape")
    want = {(1, cfg.n_heads, cfg.n_kv_heads, S, cfg.hd, w): cfg.n_layers // 2
            for w in (cfg.local_window, None)}
    if DEV.type == "cuda":
        check(launches == {"triangle_mp": 0, "cycle_intersect": 0,
                           "flash_attention": cfg.n_layers,
                           "contract_matmul": 0},
              f"prefill launched {launches}, want {cfg.n_layers} flash")
        check(dict(flash_ops.shapes) == want,
              f"prefill gave the kernel {dict(flash_ops.shapes)}")
    walls = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        prefill(params, tokens)
        sync()
        walls.append(time.perf_counter() - t0)
    sync()
    t0 = time.perf_counter()
    ref = plain(params, tokens)
    sync()
    plain_s = time.perf_counter() - t0
    vs_plain = logits_agree(logits, ref, "prefill kernel vs plain")
    check(vs_plain["greedy_agreement"] >= GREEDY_AGREE_MIN,
          f"prefill: greedy agreement {vs_plain['greedy_agreement']} < "
          f"{GREEDY_AGREE_MIN}")
    at_p0 = logits[:, P0].clone()
    del logits, ref
    prof = profile_device(lambda: prefill(params, tokens))
    prefill_syncs = count_syncs(lambda: prefill(params, tokens))

    # decode against forward on a short prompt, decode_step's own writes
    step = arch.step_fn(arch.shapes["decode_32k"])
    last = prefill(params, tokens[:, :P])[:, -1]
    cache = tfm.init_kv_cache(cfg, 1, P + 8, DEV)
    for t in range(P):
        dec, cache = step(params, cache, tokens[:, t], t)
    vs_short = logits_agree(dec, last, "decode vs forward, short prompt")
    vs_short["argmax_equal"] = bool(torch.equal(dec.argmax(-1),
                                                last.argmax(-1)))
    decode_syncs = count_syncs(lambda: step(params, cache, tokens[:, 0], P))

    # decode at a long context: S cache slots filled to P0 > the local
    # window, so the local layers' window masks; one step against the
    # prefill's logits at P0, the same step one slot late (a planted
    # fault) read under the same gate, then timed and profiled steps
    cache = tfm.init_kv_cache(cfg, 1, S, DEV)
    fill_cache(cfg, params, tokens[:, :P0], cache, "cuda")
    bad = {k: c.clone() for k, c in cache.items()}
    late, _ = step(params, bad, tokens[:, P0], P0 + 1)
    fault = logits_diff(late, at_p0)
    fault["caught_by_gate"] = fault["rel_err"] > LOGITS_REL_TOL
    del bad, late
    dec, cache = step(params, cache, tokens[:, P0], P0)
    vs_long = logits_agree(dec, at_p0, "decode vs forward, long context")
    vs_long["argmax_equal"] = bool(torch.equal(dec.argmax(-1),
                                               at_p0.argmax(-1)))
    sync()
    t0 = time.perf_counter()
    for t in range(P0 + 1, P0 + 1 + n_steps):
        step(params, cache, tokens[:, t], t)
    sync()
    decode_s = time.perf_counter() - t0

    def four_steps():
        for t in range(P0 + 1 + n_steps, P0 + 5 + n_steps):
            step(params, cache, tokens[:, t], t)
    decode_prof = profile_device(four_steps)
    del params, cache, dec, last, at_p0
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
    witness = f32_decode_witness(cfg, tokens, P0, S)
    if DEV.type == "cuda":
        torch.cuda.empty_cache()

    # launch/serve.py at full width, from its own flags
    served = serve.main(["--arch", "gemma2-9b", "--device", str(DEV)]
                        + serve_flags)
    flags = dict(zip(serve_flags[::2], serve_flags[1::2]))
    n_req, gen_len = int(flags["--requests"]), int(flags["--gen"])
    vocab = serve._reduced_lm(get_arch("gemma2-9b").cfg,
                              int(flags["--reduce"])).vocab
    check(served["served"] == n_req and all(
        len(toks) == gen_len + 1 and all(0 <= x < vocab for x in toks)
        for _, toks in served["done"]), "launch/serve.py: bad requests")

    out = dict(
        config=cfg.name, n_layers=cfg.n_layers, params=cfg.params_count,
        weight_bytes=weight_bytes, init_s=init_s, prefill_tokens=S,
        prefill_first_s=first_s, prefill_s=walls,
        prefill_s_median=statistics.median(walls),
        prefill_tokens_per_s=S / statistics.median(walls),
        plain_prefill_s=plain_s, launches=launches,
        kernel_shapes=shapes, peak_bytes=peak, vs_plain=vs_plain,
        decode_short_prompt=P, vs_forward_short=vs_short,
        decode_context=P0, decode_cache_slots=S, vs_forward_long=vs_long,
        planted_fault=fault, f32_witness=witness, decode_steps=n_steps,
        decode_s=decode_s, decode_steps_per_s=n_steps / decode_s,
        host_syncs=dict(prefill=dict(prefill_syncs),
                        decode_step=dict(decode_syncs)), profile=prof,
        decode_profile=decode_prof,
        serve=dict(flags=serve_flags, served=served["served"],
                   steps=served["steps"], seconds=served["seconds"],
                   steps_per_s=served["steps"] / served["seconds"],
                   slot_tokens_per_s=served["n_decoded"]
                   / served["seconds"]))
    log(f"  prefill {out['prefill_s_median']:.3f} s (median of 2), "
        f"{out['prefill_tokens_per_s']:.0f} tokens/s; plain attention "
        f"{plain_s:.3f} s; peak {peak / 2**30:.2f} GiB; kernel vs plain "
        f"{vs_plain}")
    log(f"  decode vs forward, {P}-token prompt: {vs_short}; at context "
        f"{P0} of {S} slots: {vs_long}; one slot late (planted fault): "
        f"{fault}; f32 witness: {witness}")
    log(f"  decode at context {P0}: {out['decode_steps_per_s']:.2f} steps/s "
        f"(batch 1, {n_steps} steps); host syncs {out['host_syncs']}")
    log(f"  launch/serve.py: {served['served']} requests, {served['steps']} "
        f"steps in {served['seconds']:.2f} s "
        f"({out['serve']['steps_per_s']:.1f} steps/s, batch "
        f"{flags['--batch']}, contexts <= 24: a smoke, not a measure)")
    if prof:
        log(f"  profiled prefill: device busy {prof['device_busy_ms']:.1f} "
            f"of {prof['wall_ms']:.1f} ms (idle share "
            f"{prof['idle_share']:.3f}); flash {prof['flash_attention']}; "
            f"top {prof['top_device_kernels'][:6]}")
        dp = decode_prof
        log(f"  profiled decode at context {P0}, 4 steps: device busy "
            f"{dp['device_busy_ms']:.1f} of {dp['wall_ms']:.1f} ms (idle "
            f"share {dp['idle_share']:.3f}), {dp['device_events']} device "
            f"events; top {dp['top_device_kernels'][:5]}")
    return out


# ---------------------------------------------------------------------------
# Phase 6: the dense data path and the other solver modes
# ---------------------------------------------------------------------------

# examples/quickstart.py's instance and config
QUICKSTART = dict(n=200, p=0.08, seed=0, pad_edges=4096, pad_nodes=256)
QUICKSTART_CFG = dict(max_neg=1024, max_tri_per_edge=8, mp_iters=10)
INTS = ("labels", "rounds", "n_contracted", "n_clusters")


def rel_close(a, b, tol: float) -> bool:
    """|a - b| <= tol · max(1, |b|); infinities must be equal."""
    a, b = float(a), float(b)
    if np.isinf(a) or np.isinf(b):
        return a == b
    return abs(a - b) <= tol * max(1.0, abs(b))


def phase_quickstart() -> dict:
    """(a) quickstart's instance (dense under auto) in all four modes: the
    kernel backend equals the plain one on the card, and the card equals
    the CPU."""
    cfg = api.SolverConfig(**QUICKSTART_CFG)
    out = {}
    for mode in api.MODES:
        inst = graph.random_instance(**QUICKSTART, device=DEV)
        reset_counters()
        kern = host(api.solve(inst, mode=mode, config=cfg, device=DEV))
        launches = all_launches()
        mp_shapes = dict(sweep_ops.shapes)
        ref = host(api.solve(inst, mode=mode, config=cfg,
                             backend="reference", device=DEV))
        diff = same_result(kern, ref)
        check(not diff, f"quickstart {mode}: kernel backend != reference "
              f"in {diff}")
        cpu = host(api.solve(graph.random_instance(**QUICKSTART,
                                                   device="cpu"),
                             mode=mode, config=cfg, device="cpu"))
        ints = [f for f in INTS if not np.array_equal(kern[f], cpu[f])]
        check(not ints, f"quickstart {mode}: card != CPU in {ints}")
        for f in ("objective", "lower_bound"):
            check(rel_close(kern[f], cpu[f], CPU_REL_TOL),
                  f"quickstart {mode}: card {f} {kern[f]} vs CPU {cpu[f]}")
        if DEV.type == "cuda":
            want = phase_launches(mp_shapes, cfg.mp_iters)
            check(launches["triangle_mp"] == want
                  and (want > 0) == (mode != "p")
                  and launches["cycle_intersect"] == 0,
                  f"quickstart {mode} (dense): launched {launches}, MP "
                  f"phases {mp_shapes}")
        out[mode] = dict(rounds=int(kern["rounds"]),
                         objective=float(kern["objective"]),
                         lower_bound=float(kern["lower_bound"]),
                         cpu_objective=float(cpu["objective"]),
                         cpu_lower_bound=float(cpu["lower_bound"]),
                         launches=launches)
        log(f"  quickstart {mode}: rounds {out[mode]['rounds']}, objective "
            f"{out[mode]['objective']}, lower bound "
            f"{out[mode]['lower_bound']} (CPU {out[mode]['cpu_objective']}, "
            f"{out[mode]['cpu_lower_bound']}), launches {launches}")
    return out


def dense_run(inst, mode: str, impl: str) -> tuple[dict, dict]:
    """One (mode, data path) on ``inst``: counters zeroed just before the
    first solve and read just after; then wall time (median of 3), host
    syncs and peak memory."""
    if DEV.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counters()
    res, first_s = timed_solve(inst, mode=mode, graph_impl=impl)
    launches = all_launches()
    mp_shapes = dict(sweep_ops.shapes)
    peak = torch.cuda.max_memory_allocated() if DEV.type == "cuda" else 0
    walls = [timed_solve(inst, mode=mode, graph_impl=impl)[1]
             for _ in range(3)]
    sites = count_syncs(lambda: api.solve(inst, mode=mode, graph_impl=impl,
                                          device=DEV))
    r = host(res)
    rec = dict(rounds=int(r["rounds"]), objective=float(r["objective"]),
               lower_bound=float(r["lower_bound"]),
               lb_history=r["lb_history"].tolist(),
               first_call_s=first_s, wall_s=walls,
               wall_s_median=statistics.median(walls),
               host_syncs=sum(sites.values()),
               host_sync_sites=dict(sites.most_common()), peak_bytes=peak,
               launches=launches,
               mp_phases={str(T): n for T, n in mp_shapes.items()},
               mp_launches_expected=phase_launches(mp_shapes))
    log(f"  {mode} {impl}: wall {rec['wall_s_median']:.4f} s (median of "
        f"3; first {first_s:.3f} s), rounds {rec['rounds']}, objective "
        f"{rec['objective']}, lower bound {rec['lower_bound']}, host syncs "
        f"{rec['host_syncs']}, peak {peak} B, launches {launches} "
        f"[{CARD_NAME}]")
    return r, rec


def lemma4_round0(inst, gen) -> dict:
    """(c) Lemma 4 on the dense pd solve's round 0: the contraction kernel
    on the dense adjacency of the round's reparametrised, chorded instance
    against the dense adjacency of the contracted instance; then the
    kernel against its plain version and cuBLAS at that shape."""
    cfg = api.SolverConfig(graph_impl="dense")
    inst2, c_rep, _, _ = solver._dual_round_core(
        inst, cfg, cfg.first_round_cycles45, solver.resolve_mp("cuda"),
        solver.resolve_intersect("cuda"))
    inst3 = inst2._replace(cost=c_rep)
    res = solver._primal_round_core(inst3, cfg)
    n_new = int(res.n_new)
    A = contraction.adjacency_dense(inst3)
    want = contraction.adjacency_dense(res.instance)[:n_new, :n_new].clone()
    reset_counters()
    got = cm_ops.contract_matmul(A, res.mapping, n_new)
    sync()
    launches = all_launches()["contract_matmul"]
    splits = cm_ops.split_launches
    check(DEV.type != "cuda" or (launches == 2 and splits == 4),
          f"lemma 4: {launches} contract_matmul launches and {splits} "
          f"split passes, want 2 and 4")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= CONTRACT_REL_TOL * scale, f"lemma 4: max |KᵀAK - A'| "
          f"{err} > {CONTRACT_REL_TOL} x {scale}")
    del got, want
    case = contract_case(inst.num_nodes, n_new, gen, A=A, f=res.mapping,
                         label="lemma 4, round 0")
    # time of each of the two products (its two split passes included),
    # by CUDA events (a torch.profiler window here recorded no device
    # events on the card)
    K = one_hot(res.mapping, n_new)
    B = cm_ops.matmul(A, K)
    launch_ms = [cuda_ms(lambda: cm_ops.matmul(A, K), 3, 1),
                 cuda_ms(lambda: cm_ops.matmul(K.T, B, drop_diag=True), 3,
                         1)]
    del K, B
    log(f"  lemma 4 on round 0: {inst.num_nodes} -> {n_new} nodes, max "
        f"|KᵀAK - A'| {err} of max |A'| {scale}, launches {launches} "
        f"(+ {splits} split passes); ms per product with its splits "
        f"{launch_ms}")
    log_case("contract_matmul", case)
    return dict(n_old=inst.num_nodes, n_new=n_new, max_abs_err=err,
                max_abs_ref=scale, launches=launches, split_launches=splits,
                case=case, launch_ms=launch_ms)


def phase_dense(h: int, w: int, max_neg: int, gen) -> dict:
    out = {"quickstart": phase_quickstart()}
    E = grid_edges(h, w)
    inst = graph.grid_instance(h, w, seed=0, pad_edges=E + 4 * max_neg,
                               device=DEV)
    sync()
    log(f"  instance {h}x{w}: {inst.num_nodes} nodes, {E} edges "
        f"(+{inst.num_edges - E} chord slots)")
    runs = {}
    for mode in ("pd", "d"):
        rd, dense = dense_run(inst, mode, "dense")
        rs, sparse = dense_run(inst, mode, "sparse")
        ints = [f for f in INTS if not np.array_equal(rd[f], rs[f])]
        check(not ints, f"{mode}: dense != sparse in {ints}")
        for f in ("objective", "lower_bound"):
            check(rel_close(rd[f], rs[f], DENSE_REL_TOL),
                  f"{mode}: dense {f} {rd[f]} vs sparse {rs[f]}")
        check(all(rel_close(a, b, DENSE_REL_TOL) for a, b in
                  zip(rd["lb_history"], rs["lb_history"])),
              f"{mode}: dense and sparse lower-bound histories differ")
        if mode == "pd":
            check_solution(inst, rd, "dense pd")
        if DEV.type == "cuda":
            for impl, rec in (("dense", dense), ("sparse", sparse)):
                n = rec["launches"]["triangle_mp"]
                check(n > 0 and n == rec["mp_launches_expected"]
                      and (rec["launches"]["cycle_intersect"] > 0)
                      == (impl == "sparse"),
                      f"{impl} {mode}: launched {rec['launches']}, MP "
                      f"phases {rec['mp_phases']}")
        runs[mode] = dict(dense=dense, sparse=sparse)
    prof = profile_solve(inst, mode="pd", graph_impl="dense")
    if prof:
        busy = prof["device_busy_ms"]
        log(f"  profiled dense pd solve: device busy {busy:.1f} of "
            f"{prof['wall_ms']:.1f} ms (idle share "
            f"{1 - busy / prof['wall_ms']:.3f}); phases {prof['phases']}; "
            f"kernels {prof['kernels']} [{CARD_NAME}]")
    out.update(instance=dict(h=h, w=w, nodes=inst.num_nodes, edges=E,
                             pad_edges=inst.num_edges),
               runs=runs, profile=prof, lemma4=lemma4_round0(inst, gen))
    return out


def main_path_cases(main: dict, gen) -> dict:
    """Hold each kernel against its plain version at every shape the main
    path gave it (fresh data of those shapes)."""
    out = {"triangle_mp": [], "cycle_intersect": []}
    E = main["instance"]["pad_edges"]
    for T in sorted(main["main_shapes"]["triangle_mp"]):
        out["triangle_mp"].append(phase_case(T, E, T // 8, gen,
                                             "main path"))
    for (R, W, Wj) in sorted(main["main_shapes"]["cycle_intersect"]):
        out["cycle_intersect"].append(intersect_case(R, W, Wj, gen))
    return out


def kernel_line(cases: dict, main_cases: dict, main: dict,
                lm: dict, dense: dict) -> dict:
    rows = []
    for name, meta in KERNELS.items():
        if name == "contract_matmul":
            l4 = dense["lemma4"]
            head = l4["case"]               # the shape phase 6 (c) gave it
            every = cases[name] + [head]
            rows.append(dict(
                name=name, route="cuda", source=meta["source"],
                replaces=meta["replaces"], launches=l4["launches"],
                max_abs_err=max(c["max_abs_err"] for c in every),
                shape=head["shape"], ms=head["kernel_ms"],
                kernel_ms=head["kernel_ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                bound_note="three TF32 tensor-core products (3xTF32) at "
                           "495 TFLOP/s",
                fp32_pipe_bound_ms=head["fp32_pipe_bound_ms"],
                bound_share=head["bound_share"],
                tflop_per_s=head["tflop_per_s"],
                library_ms=head["library_ms"],
                library_note="the same two products through cuBLAS SGEMM "
                             "(torch.matmul, TF32 off), K prebuilt",
                split_launches=l4["split_launches"],
                peak_bytes=head["peak_bytes"],
                scratch_peak_bytes=head["scratch_peak_bytes"],
                device_us_per_launch=1e3 * statistics.mean(
                    l4["launch_ms"]),
                cases=every))
            continue
        if name == "flash_attention":
            head = cases[name][0]                   # gemma2 global layers
            rows.append(dict(
                name=name, route="cuda", source=meta["source"],
                replaces=meta["replaces"],
                launches=lm["launches"][name],
                max_abs_err=max(c["max_abs_err"] for c in cases[name]),
                shape=head["shape"], ms=head["kernel_ms"],
                kernel_ms=head["kernel_ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                library_ms=head["library_ms"],
                library_note="scaled_dot_product_attention, causal, softcap "
                             "off (and window off)",
                library_kernel=head["library_kernel"],
                tflop_per_s=head["tflop_per_s"],
                bound_share=head["bound_share"],
                device_us_per_launch=lm.get("profile", {}).get(
                    "flash_attention", {}).get("device_us_per_launch"),
                cases=cases[name]))
            continue
        shapes = main["main_shapes"][name]
        top = max(shapes, key=shapes.get)       # most launched shape
        key = [top, 3] if name == "triangle_mp" else \
            [[top[0], top[1]], [top[0], top[2]]]
        head = next(c for c in main_cases[name] if c["shape"] == key)
        every = cases[name] + main_cases[name]
        prof = main.get("profile", {})
        if name == "triangle_mp":
            extra = dict(
                bound_share=head["bound_share"],
                call_device_us=head["call_device_us"],
                mp_phases=sum(shapes.values()),
                message_passing_span=prof.get("phases", {}).get(
                    "repro.message_passing"),
                sweep_cases=[c for c in cases[name]
                             if c["label"] == "sweep"],
                bound_note="the phase kernel's reads of the valid rows, "
                           "their sorted keys and the touched edges' costs, "
                           "and its writes of the valid rows and touched "
                           "edges")
        else:
            extra = dict(
                host_us=head["host_us"], device_us=head["device_us"],
                library_host_us=head["library_host_us"],
                library_device_us=head["library_device_us"],
                launch_breakdown=cases["launch_breakdown"])
        rows.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=main["launches"][name],
            max_abs_err=max(c["max_abs_err"] for c in every),
            shape=head["shape"], ms=head["kernel_ms"],
            kernel_ms=head["kernel_ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            library_note=(None if name == "triangle_mp" else
                          "torch.searchsorted: the search half only"),
            device_us_per_launch=prof.get("kernels", {}).get(
                name, {}).get("device_us_per_launch"),
            **extra, cases=every))
    return {"kernels": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                        "chip_smoke.json"))
    p.add_argument("--rehearse", action="store_true",
                   help="run the phases on the CPU at small sizes; prints "
                        "no result and exits 3")
    args = p.parse_args(argv)
    main_grid, cpu_grid = GRIDS["rehearse" if args.rehearse else "card"]
    if args.rehearse:
        global DEV
        DEV = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    elif torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} cards visible; "
              f"this script drives one", file=sys.stderr)
        return 2
    global CARD_NAME
    card = nvidia_smi() if DEV.type == "cuda" else "rehearsal on the CPU"
    CARD_NAME = card
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, device=str(DEV))
    try:
        log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, Python {sys.version.split()[0]}")
        record["build_s"] = _build.build_all() if DEV.type == "cuda" \
            else 0.0
        log(f"  built kernels in {record['build_s']:.2f} s")
        record["ptxas"] = {name: _build.ptxas_report(name)
                           for name in _build.build_log}
        for name, rows in record["ptxas"].items():
            for r in rows:
                log(f"  {name}: {r['function']}: {r.get('registers')} "
                    f"registers, {r.get('stack')} B stack, "
                    f"{r.get('spill_stores')} / {r.get('spill_loads')} B "
                    f"spilled (stores / loads), ptxas notes "
                    f"{r['notes'] or 'none'}")
        gen = torch.Generator(device=DEV).manual_seed(0)
        log("phase 2: kernels against their plain versions")
        cases = phase_kernels(gen, small=args.rehearse)
        log("phase 3: main path")
        main_rec = phase_main(*main_grid, api.SolverConfig().max_neg)
        main_cases = main_path_cases(main_rec, gen)
        record["main_path"] = main_rec
        log("phase 4: card against CPU")
        record["cpu_parity"] = phase_cpu(*cpu_grid)
        log("phase 5: LM serving, gemma2-9b")
        record["lm"] = phase_lm(args.rehearse)
        log("phase 6: dense path and modes p, pd, pd+, d")
        record["dense"] = phase_dense(
            *DENSE_GRID["rehearse" if args.rehearse else "card"],
            api.SolverConfig().max_neg, gen)
        line = kernel_line(cases, main_cases, main_rec, record["lm"],
                           record["dense"])
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    if args.rehearse:
        print("chip_smoke: rehearsal finished on the CPU; no result",
              file=sys.stderr)
        return 3
    del record["main_path"]["main_shapes"]
    record.update(line)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
