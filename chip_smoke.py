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
7. The solve server (``repro_torch.serve.SolveEngine``: default bucket
   policy and router, batch cap 4, in-flight window 2, the kernels).
   (a) 16 tiles in one ``solve_stream``: 8 ``grid_instance(h, w)`` with
   h, w in 12..16 (dense route), 4 of 128×128 and 4 of 256×512 (sparse
   route), seeds 0..15 in a seeded order, counters zeroed just before and
   read just after (both multicut kernels must launch). Every result
   equals ``api.solve`` of its bucket-padded instance on its route
   (labels, histories, objective and bound bit for bit); first-calls stay
   within buckets × routes × ladder rungs; the 128×128 sub-stream again
   with ``max_inflight=0`` is bit-identical, with its host syncs per
   dispatch counted; one 1-slot dispatch of the 256×512 bucket is
   profiled. Prints requests/s, p50/p95 latency per route, dispatches,
   occupancy, first-calls, peak memory, the idle share and device time
   by kernel of the profiled dispatch. (b) A session on the main path's
   grid: the engine's cold open, one exact tick (1 000 reweights, 100
   inserts, 100 deletes from a seed) equal to a cold ``api.solve`` of the
   patched padded instance, then two warm ticks through
   ``api.solve_delta`` on the carried state, each objective within 1e-5
   of a float64 host recount and its carried bound below it; prints the
   cold, exact-tick and warm-tick walls and the phase's seconds.

8. Solve traces, Table 1, streamed ingest and the roofline. (a) The main
   path with ``trace=True``: labels, rounds, histories, objective and
   bound bit for bit equal to phase 3's, with the same host syncs and
   launches; the trace's bound rows equal ``lb_history`` and its last
   objective the result's; prints each round's row (bound, objective,
   cycles, contractions, clusters, MP gain), the gap, and the traced wall
   against the untraced (medians of 3). (b) Modes p, pd+ and d traced on
   ``grid_instance(128, 128)``, dense and sparse, each bit-equal to its
   untraced solve. (c) The paper's Table 1 on the card: on
   ``grid_instance(128, 128, seed=0)`` the port's GAEC, GEF, BEC,
   greedy-join local search and ICP on the host, each timed, and RAMA pd
   on the card at the default preset and at ``max_rounds=64``; on the
   main path's grid GAEC and RAMA pd at both settings. Every labelling
   must be a partition, ``baselines.objective`` equal a float64 recount
   within 1e-5, and every lower bound lie below every feasible objective
   on its instance; quality is reported, not gated. (d) The main path's
   grid streamed back through ``make_instance_streamed`` in chunks of
   2^18 edges: leaves equal to the generator's, the solve equal to phase
   3's, peak host slots = pad_edges + chunk; prints the ingest seconds
   and the pinned host-to-device copy's GB/s. (e)
   ``roofline.profile_solve_round`` on the main path (sparse) and on
   128×128 dense, against the card's ``Hardware`` entry (its name must be
   nvidia-smi's): per phase wall, bytes, flops, dominant term, roofline
   seconds and share, beside phase 3's and 6's profiled spans; then the
   ``rama-multicut`` cells' steps (``pd_round_sm``, ``pd_round_lg``,
   ``mp_sweep_1m``, which must launch ``triangle_mp``) on inputs from a
   seed, timed, with their model-FLOPs rate.
9. The edge-range-sharded solve and the block decomposition; the
   process group it makes is destroyed before the summary lines. (a) On
   an in-process NCCL group of one rank (a FileStore under
   ``chiprun_out/``): the main path's grid padded by ``round_up_edges``
   (2 609 168 slots) through ``preset="pd-state-sharded"`` (S = 1),
   counters zeroed just before and read just after (``cycle_intersect``
   must launch, ``triangle_mp`` once per MP phase), against the
   replicated sparse solve of the same config: labels, rounds and
   histories equal, objective and bound within 1e-5 relative, the
   objective within 1e-5 of a float64 host recount, the bound below it;
   the traced solve bit-equal with ``shard_*`` rows of width 1; walls of
   both (medians of 3 after a warm-up), host syncs, peak memory, one
   profiled sharded solve; each kernel held against its plain version at
   any shape this path gave it that phase 3 did not. (b) Two child
   processes on the same card over gloo (``repro_torch.launch.ranks``),
   S = 2 on ``grid_instance(128, 128)``: each rank's result, untraced
   and traced, bit-identical to S = 1 in this process, both kernels
   launched in each rank; per-shard trace rows and walls. (c)
   ``random_instance(400, 0.05, seed=3)`` cut into 8 blocks of 64 nodes:
   the distributed round on the one-rank group, the quotient of the
   contracted blocks solved, the bound below the replicated objective and
   the quotient's lifted objective; the ``dist_pd`` cell's step at its
   own dims, timed. Each rank of (b) also profiles its sharded round
   (``profile_solve_round``) and records that it destroyed its group.
10. Sharding over cards in one process, on S copies of the one card
   (``copies_of_card``: ``torch.cuda.device_count`` says S and the shard
   device map sends every shard to ``cuda:0``; the log says so). (a) The
   main path's instance at ``pd-sharded``: as resolved on the card (S =
   1, the warm-up), then S = 2 and 4; labels, rounds, histories,
   objective and bound bit-equal across S, to ``pd-chunked`` and to
   phase 3's solve; per S one timed run (launch counters zeroed just
   before and read just after; one triangle_mp phase per round, its
   launches those of the counted phases) and the host syncs of another.
   (b) ``solve_batch`` of four 128×128 grids at ``batch_shards`` 1, 2 and
   4, bit-identical (means of 2, run in the order 1, 2, 4, 4, 2, 1);
   phase 7's four 128×128 tiles through a router with ``batch_shards=2``,
   each equal to ``api.solve`` of its padded tile, first-calls within the
   budget. (a) and (b) then hold both multicut kernels against their
   plain versions at every shape their runs gave them that no earlier
   case covered (checks only, untimed). (c)
   ``profile_solve_round`` of the main grid at ``pd-state-sharded`` on a
   one-rank NCCL group (per phase wall, bytes, flops, collective bytes,
   share of the bound), then phase 9 (b)'s two S = 2 profiles with each
   rank's collective bytes.
11. MoE serving and the LM train step, at full width, depth cut to fit
   one card. (a) llama4-scout-17b-a16e at 4 of 48 layers (16 experts
   top-1, ~20.8 GB of bf16 weights), then grok-1-314b at 2 of 64 (8
   experts top-2, ~22.9 GB), the first freed: prefill (1, 8192) through
   the flash kernel (counted: L launches at (1, Hq, 8, 8192, 128)) and
   through plain attention, phase 5's gates on the logits; per layer the
   routing (tokens per expert, dropped choices, exact gate ties), equal
   to the CPU's routing of the card's own gates, and between the two
   routes equal wherever the router logits are; then decode at context
   8000 of an 8192-slot cache from the first position there that every
   layer kept: its token equals the prefill's argmax, and 4 more steps
   timed. (b) gemma2-9b at 2 of 42 layers (one local/global pair; the
   full depth's f32 masters, gradients and AdamW moments need ~162 GB):
   five registry train steps on ``lm_batch`` (1, 8192) with its
   optimizer unwarmed, each launching the flash kernel 2 L times
   (forward and the remat recompute); step 1's loss within 1e-2 of the
   plain route's, each attention layer's q, k, v gradients bit-equal to
   the plain route's on the same inputs and cotangent; batch 0's loss
   lower after the five steps; a checkpoint after step 3 (host copy,
   then written on a thread), restored, and steps 4-5 again: the same
   losses and params bit for bit. (c) ``launch/train.py`` and
   ``launch/serve.py`` (both MoE archs) on the card at ``--reduce 16``.
   Then the flash kernel against its plain version at the two MoE
   prefill shapes.
12. The sparse substrate's families at full width, all torch ops (none
   of the four kernels; each path's counters must read 0), float32
   matmuls with TF32 off. (a) wide-deep (40 fields of 10^6 rows x 32,
   5.12 GB of tables): ``serve_p99`` (512) and ``serve_bulk`` (262 144)
   through the registry's serve step, median latency and examples/s;
   the first 4 096 bulk logits against the port's CPU forward on the
   same tables (rel 1e-4); ``retrieval_cand`` (1 000 448 padded
   candidates x 64, top 128; no padding row may win) against the CPU
   (values rtol 1e-5, indices equal where the values are distinct);
   three registry train steps at 65 536 on one batch: the loss falls,
   step walls, peak memory. (b) The registry's train steps: dimenet,
   egnn and mace on ``molecule`` (N 4 096, E 8 192, dimenet's T 16 384),
   graphcast's processor on ``full_graph_sm`` (padded 3 072 / 10 752,
   d_feat 1 433) and ``minibatch_lg`` (196 608 / 212 992, d_feat 602):
   four steps on one batch (a warm-up, the median of three timed), the
   loss falling, peak memory, model TFLOP/s; on ``molecule`` and
   ``full_graph_sm`` step 1's loss and gradient norm within 1e-3 of the
   port on the CPU (same params and batch). (c) GraphCast's native
   weather path at its config (refinement 6: 40 962 mesh nodes, 327 660
   mesh edges; 181 x 360 grid; 227 vars; 16 x 512): the host topology's
   seconds, forwards and train steps with walls and peaks, a 2-step
   rollout that stays finite. (d) ``repro_torch.examples.gnn_multicut``
   on the card (its RAMA-agreement assert), its solve equal to the plain
   backend's bit for bit and to the CPU's solve of the same costs
   (labels and integers exactly, objective and bound within 1e-5
   relative), ``triangle_mp`` held against its plain version at the
   shapes this solve gave it.
13. The owner-partitioned DimeNet block over ``torch.distributed`` and
   the four multicut examples, float32 with TF32 off. (a)
   ``models/gnn/partitioned.py`` at DimeNet's width d = 128 and
   ``minibatch_lg``'s 212 992 edges, T = 425 984 triplets from a seed
   (90 % valid), halo E/D a peer and T a shard (nothing dropped): D = 1
   in this process and D = 2 over two gloo ranks on the card
   (``make_debug_mesh(1, 2)``; NCCL refuses two ranks on one GPU), each
   within max |Δ| / max |ref| <= 1e-5 of the dense reference on the
   card, of each other and of the CPU's block; a second plan whose halo
   cap (E/32 a peer) drops triplets, against the dense reference over
   the triplets it kept. Prints the plan's host seconds, the block's ms
   a rank (median of 3 after the counted first call), each rank's
   ``all_to_all`` bytes (``count_collective_bytes``: D·H·d·4) and peak
   memory. (b) ``repro_torch.examples`` quickstart,
   image_segmentation, serve_tiles and distributed_multicut (on a
   one-rank NCCL group) through their ``main`` with their asserts,
   counters zeroed just before each and read just after: ``triangle_mp``
   launched in each, ``cycle_intersect`` in the two whose solves take
   the sparse path; both kernels held against their plain versions at
   the shapes each example gave them.
14. The sharding plans (``repro_torch.sharding``, the registry's
   ``state_shardings``/``input_shardings``). (a) The pod dry-run
   (``repro_torch.launch.dryrun``) of one cell a family on the host over
   a ``fake`` group of 256 ranks, in a child process while (b) runs:
   granite-34b train_4k, grok-1-314b decode_32k (the expert fallback),
   graphcast minibatch_lg, wide-deep train_batch, rama-multicut dist_pd;
   each record printed, any failing cell fails the phase. (b) gemma2-9b
   at 2 layers of full width, prefill (1, 8192), its float32 master
   params placed as DTensors by its plan on a one-rank NCCL mesh
   (``make_debug_mesh(1, 1)``): the logits bit-equal to the plain
   one-card prefill, ``flash_attention`` launched once a layer through
   ``local_map``; the dry-run of the same cell (a one-rank fake group)
   gives argument bytes equal to the live local bytes, matmul flops
   equal to ``FlopCounterMode`` on the same step through the plain
   attention and all flops equal to the dry-run's counter there; its
   predicted peak is printed beside the measured one, as a ratio.

Prints the ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Writes the
full record to ``chiprun_out/chip_smoke.json``.

``--rehearse`` runs the same phases on the CPU at small sizes (a 20×20
main-path grid, a 17×17 card-vs-CPU grid, attention at S <= 128, a
2-layer gemma2 of width 64, contraction cases up to (513, 100), a 20×20
dense-path grid, phase 7's tiles at 12..16 squared with 16×16 and 17×17
(the sparse route) in place of its two large shapes, and a 24×24 session
grid with patches of 40, 5 and 5, phase 8 on 20×20 grids with 64-edge
ingest chunks and small arch cells, phase 9 on a one-rank gloo group
with 20×20 and 12×12 grids and a small ``dist_pd`` cell, phase 10 on the
20×20 grid and 16×16 batches, phase 11 on width-64 copies of its
archs at S = 128 (MoE) and 48 (training), phase 12 at 1 000 rows a
field, batches of 16-64, 2-layer GNNs of width 16-32 on 512 padded
nodes and edges, the weather example's config), phase 13's block at
E 2 048 and d 16 and the four examples at their own sizes, phase 14's
dry-run of four cheaper full-width cells (grok-1-314b long_500k, egnn
full_graph_sm, wide-deep serve_p99, rama-multicut dist_pd) and its
prefill at width 64 and S = 128 on a one-rank gloo group, with each
kernel wrapper running its plain version, to
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
import tempfile
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
import torch.distributed as tdist  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import api  # noqa: E402
from repro_torch import roofline  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import baselines, contraction, graph, solver  # noqa: E402,E501
from repro_torch.core import dist as dist_mod  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.contract_matmul import ops as cm_ops  # noqa: E402
from repro_torch.kernels.contract_matmul.ref import (  # noqa: E402
    contract_matmul_ref, full_fp32, one_hot,
)
from repro_torch.kernels.cycle_intersect import ops as isect_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.chunked import chunked_attention  # noqa: E402,E501
from repro_torch.launch import ranks, serve  # noqa: E402
from repro_torch import serve as solve_server  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.obs import summarize  # noqa: E402
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref  # noqa: E402,E501
from repro_torch.kernels.triangle_mp import ops as sweep_ops  # noqa: E402
from repro_torch.kernels.triangle_mp.ref import (  # noqa: E402
    mp_phase_ref, mp_sweep_ref,
)
from repro_torch.sparse import segment_ops  # noqa: E402

# the card's data-sheet peaks, from the port's one table of them
HBM_BYTES_PER_S = roofline.HW.hbm_bw
FP32_OPS_PER_S = roofline.FP32_FLOPS
BF16_OPS_PER_S = roofline.HW.peak_flops
TF32_OPS_PER_S = roofline.TF32_FLOPS
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
    ops, bytes_moved = sweep_ops.sweep_work(T)
    bound_ms, by = bound(bytes_moved, ops)

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
                work=dict(ops=ops, bytes=bytes_moved),
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


def phase_case(T: int, E: int, n_valid: int, gen, label: str,
               iters: int = MP_ITERS, timed: bool = True) -> dict:
    """The fused MP phase (``mp_phase``) against ``mp_phase_ref`` on the
    same inputs: t_cost, c_rep and lb bitwise equal; its launches; kernel
    ms of the whole call (plan, kernel, landing buffer, lower bound) and
    of the plain version; profiled device µs of the phase kernels per
    call and of the whole call; the kernels' bound from the plan's reads
    and writes. ``timed=False`` keeps the check and drops the timings."""
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
    rec = dict(label=label, shape=[T, 3], edges=E, n_valid=n_valid,
               iters=iters, route="one launch" if fused else
               "a launch per pass + landing", launches=want_launches,
               bitwise=all(same), max_abs_err=err)
    if not timed:
        return rec
    # the kernels' own reads, writes and ops on these inputs
    ops, bytes_moved = sweep_ops.work(cost, tri, valid, iters)
    bound_ms, by = bound(bytes_moved, ops)

    def call():
        return sweep_ops.mp_phase(cost, ev, tri, valid, iters)
    kernel_us = device_us(call, symbols=PHASE_SYMBOLS)
    return dict(rec, kernel_ms=cuda_ms(call),
                plain_ms=cuda_ms(lambda: mp_phase_ref(cost, ev, tri, valid,
                                                      iters)),
                device_us=kernel_us, call_device_us=device_us(call),
                library_ms=None, bound_ms=bound_ms, bound_by=by,
                work=dict(ops=ops, bytes=bytes_moved),
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


def intersect_case(R: int, W: int, Wj: int, gen, ci=None,
                   timed: bool = True) -> dict:
    """``intersect_rows`` against ``intersect_rows_ref`` on fresh sorted
    rows of this shape: equal; then (unless ``timed=False``) the kernel,
    plain and library times and the bound."""
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
    if not timed:
        return dict(shape=[[R, W], [R, Wj]], equal=equal, max_abs_err=err,
                    matches=int((got >= 0).sum()))
    # one upper-bound search of ceil(log2(Wj + 1)) compares per element
    ops, bytes_moved = isect_ops.work(R, W, Wj)
    bound_ms, by = bound(bytes_moved, ops)

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
                library_ms=cuda_ms(library), bound_ms=bound_ms, bound_by=by,
                work=dict(ops=ops, bytes=bytes_moved),
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


def path_shapes() -> dict:
    """The shapes the multicut kernels' wrappers counted since the last
    ``reset_counters``."""
    return {"triangle_mp": dict(sweep_ops.shapes),
            "cycle_intersect": dict(isect_ops.shapes)}


def merge_shapes(into: dict, shapes: dict):
    for name, counts in shapes.items():
        for key, n in counts.items():
            into[name][key] = into[name].get(key, 0) + n


def shape_record(shapes: dict) -> dict:
    return {k: {str(s): n for s, n in v.items()} for k, v in shapes.items()}


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
    """:func:`profile_call` of one ``api.solve`` (the main path's unless
    ``kw`` says otherwise)."""
    return profile_call(lambda: api.solve(inst, device=DEV, **kw))


def profile_call(fn) -> dict:
    """One call of ``fn`` under
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
        fn()
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
    main_shapes = path_shapes()
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
        shapes=shape_record(main_shapes))
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
    out["_inst"], out["_result"] = inst, r      # for phase 8; not written
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


# ---------------------------------------------------------------------------
# Phase 7: the solve server
# ---------------------------------------------------------------------------

# (a) the tile stream: 8 small tiles (h, w in 12..16: dense route), 4 of
# the middle and 4 of the large shape (sparse route), seeds 0..15, arriving
# in a seeded random order; (b) the delta session's grid and each tick's
# patch (reweights, inserts, deletes)
SERVE_TILES = {"card": ((128, 128), (256, 512)),
               "rehearse": ((16, 16), (17, 17))}
SESSION = {"card": ((512, 1024), (1000, 100, 100)),
           "rehearse": ((24, 24), (40, 5, 5))}
SERVE_BATCH_CAP = 4
SERVE_INFLIGHT = 2
SERVE_PATCH_CAP = 2048
WARM_REL_TOL = 1e-5     # warm objective vs float64 host recount


def tile_stream(rehearse: bool) -> list:
    rng = np.random.default_rng(0)
    mid, large = SERVE_TILES["rehearse" if rehearse else "card"]
    shapes = [tuple(int(x) for x in rng.integers(12, 17, size=2))
              for _ in range(8)] + [mid] * 4 + [large] * 4
    return [graph.grid_instance(*shapes[i], seed=int(i), device=DEV)
            for i in rng.permutation(len(shapes))]


def serve_engine(**kw):
    return solve_server.SolveEngine(
        router=solve_server.default_router(),
        policy=solve_server.BucketPolicy(), batch_cap=SERVE_BATCH_CAP,
        patch_cap=SERVE_PATCH_CAP, device=DEV, **kw)


def traced_stream(eng, insts):
    """``eng.solve_stream(insts)`` keeping its tickets (for per-route
    latency) and its wall seconds."""
    tickets = []
    submit_many = eng.submit_many

    def keep(xs):
        tickets.extend(submit_many(xs))
        return tickets
    eng.submit_many = keep
    sync()
    t0 = time.perf_counter()
    results = eng.solve_stream(insts)
    sync()
    return results, tickets, time.perf_counter() - t0


def stripped(res, n: int) -> dict:
    r = host(res)
    r["labels"] = r["labels"][:n]
    return r


def phase_serve_stream(rehearse: bool) -> dict:
    """(a) 16 tiles through one ``solve_stream``; every result against
    ``api.solve`` of its bucket-padded instance on its route, bit for bit;
    the compile budget; both multicut kernels launched; the middle shape's
    sub-stream again with ``max_inflight=0``, bit-identical, with its host
    syncs counted; one sparse dispatch of the large bucket profiled."""
    insts = tile_stream(rehearse)
    eng = serve_engine(max_inflight=SERVE_INFLIGHT)
    if DEV.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counters()
    results, tickets, wall = traced_stream(eng, insts)
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated() if DEV.type == "cuda" else 0
    check(launches.pop("flash_attention") == 0
          and launches.pop("contract_matmul") == 0,
          "the stream launched the attention or contraction kernel")
    check(DEV.type != "cuda" or all(n > 0 for n in launches.values()),
          f"the stream's sparse dispatches did not launch both kernels: "
          f"{launches}")
    st = eng.stats
    keys = {(t.bucket, t.route) for t in tickets}
    buckets = {k[0] for k in keys}
    routes = {eng._static_route.get(k[1], k[1]) for k in keys}
    budget = len(buckets) * len(routes) * len(
        solve_server.batch_ladder(SERVE_BATCH_CAP))
    check(st.n_completed == len(insts) and st.compiles <= budget,
          f"stream: {st.n_completed} served, {st.compiles} first-calls "
          f"over the budget {budget}")
    by_route = {}
    for inst, t, res in zip(insts, tickets, results):
        r = t.route
        ref = api.solve(solve_server.pad_instance(inst, t.bucket),
                        mode=r.mode, config=r.config, backend=r.backend,
                        device=DEV)
        got, want = stripped(res, inst.num_nodes), \
            stripped(ref, inst.num_nodes)
        diff = same_result(got, want)
        check(not diff, f"engine result != api.solve of the padded "
              f"{inst.num_nodes}-node tile in {diff}")
        check_solution(inst, got, f"tile {inst.num_nodes}")
        by_route.setdefault(r.config.graph_impl, []).append(t.latency_s)
    latency = {impl: dict(n=len(ls), p50_s=float(np.percentile(ls, 50)),
                          p95_s=float(np.percentile(ls, 95)))
               for impl, ls in by_route.items()}

    n_mid = int(np.prod(SERVE_TILES["rehearse" if rehearse else "card"][0]))
    mid = [k for k, i in enumerate(insts) if i.num_nodes == n_mid]
    sync_eng = serve_engine(max_inflight=0)
    sub = {}
    sites = count_syncs(lambda: sub.update(
        r=sync_eng.solve_stream([insts[k] for k in mid])))
    for a, b in zip(sub["r"], [results[k] for k in mid]):
        check(not same_result(host(a), host(b)),
              "max_inflight=0 differs from the overlapped engine")
    n_disp = sync_eng.stats.n_dispatches
    syncs = sum(sites.values())

    big = next(t for t in tickets if t.inst.num_nodes == max(
        i.num_nodes for i in insts))
    fn = api.compiled_solve(mode=big.route.mode, config=big.route.config,
                            backend=big.route.backend, batched=True)
    batch = solve_server.pad_batch([big.inst], big.bucket, 1)
    prof = profile_call(lambda: fn(batch))
    out = dict(
        requests=len(insts), wall_s=wall, requests_per_s=len(insts) / wall,
        latency_by_route=latency, dispatches=st.n_dispatches,
        occupancy=st.occupancy, filler_slots=st.n_filler_slots,
        compiles=st.compiles, compile_budget=budget,
        buckets=sorted([list(b) for b in buckets]),
        inflight_high_water=st.inflight_high_water, launches=launches,
        peak_bytes=peak, sub_stream=dict(
            requests=len(mid), dispatches=n_disp, host_syncs=syncs,
            host_syncs_per_dispatch=syncs / max(n_disp, 1),
            host_sync_sites=dict(sites.most_common(8))),
        profiled_dispatch=dict(bucket=list(big.bucket), slots=1, **prof))
    log(f"  stream: {len(insts)} requests in {wall:.3f} s "
        f"({out['requests_per_s']:.3f} requests/s), latency by route "
        f"{latency}, {st.n_dispatches} dispatches, occupancy "
        f"{st.occupancy:.3f}, first-calls {st.compiles} (budget {budget}), "
        f"launches {launches}, peak {peak} B [{CARD_NAME}]")
    log(f"  sub-stream of {len(mid)} with max_inflight=0: bit-identical; "
        f"{n_disp} dispatches, {syncs} host syncs "
        f"({out['sub_stream']['host_syncs_per_dispatch']:.1f} a dispatch) "
        f"[{CARD_NAME}]")
    if prof:
        busy = prof["device_busy_ms"]
        log(f"  profiled sparse dispatch {list(big.bucket)}: device busy "
            f"{busy:.1f} of {prof['wall_ms']:.1f} ms (idle share "
            f"{1 - busy / prof['wall_ms']:.3f}); kernels {prof['kernels']};"
            f" top {prof['top_device_kernels'][:5]} [{CARD_NAME}]")
    return out


def seeded_patch(inst, seed: int, sizes) -> tuple:
    """(make_patch kwargs) from a seed: reweights and deletes of distinct
    live edges of ``inst``, inserts of absent pairs of live nodes."""
    n_rw, n_ins, n_del = sizes
    rng = np.random.default_rng(seed)
    ev = inst.edge_valid.cpu().numpy()
    u, v = inst.u.cpu().numpy()[ev], inst.v.cpu().numpy()[ev]
    n = int(inst.node_valid.sum())
    pick = rng.choice(len(u), size=n_rw + n_del, replace=False)
    rw, de = pick[:n_rw], pick[n_rw:]
    have = set((u.astype(np.int64) * n + v).tolist())
    ins = []
    while len(ins) < n_ins:
        a, b = sorted(rng.choice(n, size=2, replace=False).tolist())
        if a * n + b not in have:
            have.add(a * n + b)
            ins.append((a, b))
    ia, ib = np.array(ins, dtype=np.int64).T
    return dict(reweight=(u[rw], v[rw],
                          rng.normal(0, 1.5, n_rw).astype(np.float32)),
                insert=(ia, ib, rng.normal(0, 1.5, n_ins).astype(np.float32)),
                delete=(u[de], v[de]))


def phase_serve_session(rehearse: bool, max_neg: int) -> dict:
    """(b) A sticky session on the main path's grid: the engine's cold open
    and one exact tick (against a cold ``api.solve`` of the patched padded
    instance, bit for bit), then two warm ticks through ``api.solve_delta``
    on the session's carried state (objective against a float64 recount,
    carried bound below it)."""
    (h, w), sizes = SESSION["rehearse" if rehearse else "card"]
    E = grid_edges(h, w)
    inst = graph.grid_instance(h, w, seed=0, pad_edges=E + 4 * max_neg,
                               device=DEV)
    eng = serve_engine(max_inflight=SERVE_INFLIGHT)
    sync()
    t0 = time.perf_counter()
    s = eng.open_session(inst, warm=False)
    sync()
    cold_s = time.perf_counter() - t0
    cold_open = host(s.last_result)
    check_solution(inst, cold_open, "session cold open")
    r = s.route
    kw = dict(mode=r.mode, config=r.config, backend=r.backend, device=DEV)
    patch = api.make_patch(s.bucket.nodes, pad_entries=SERVE_PATCH_CAP,
                           device=DEV, **seeded_patch(s.state.instance, 100,
                                                      sizes))
    padded = solve_server.pad_instance(inst, s.bucket)
    sync()
    t0 = time.perf_counter()
    res = eng.submit_delta(s.session_id, patch).result()
    sync()
    exact_s = time.perf_counter() - t0
    want = api.apply_patch_host(padded, patch)
    check(all(torch.equal(a, b) for a, b in zip(s.state.instance, want)),
          "the session's patched instance != the host reference")
    cold = api.solve(want, **kw)
    diff = same_result(stripped(res, inst.num_nodes),
                       stripped(cold, inst.num_nodes))
    check(not diff, f"exact tick != cold solve of the patched instance in "
          f"{diff}")
    state = s.state
    warm = []
    for k in range(2):
        patch = api.make_patch(s.bucket.nodes, pad_entries=SERVE_PATCH_CAP,
                               device=DEV, **seeded_patch(state.instance,
                                                          101 + k, sizes))
        sync()
        t0 = time.perf_counter()
        wres, state = api.solve_delta(state, patch, warm=True, **kw)
        sync()
        wall = time.perf_counter() - t0
        lab = state.labels.cpu().numpy()
        i2 = state.instance
        cut = i2.edge_valid.cpu().numpy() & (lab[i2.u.cpu().numpy()]
                                             != lab[i2.v.cpu().numpy()])
        obj64 = float(i2.cost.cpu().numpy().astype(np.float64)[cut].sum())
        obj, lb = float(wres.objective), float(wres.lower_bound)
        check(abs(obj - obj64) <= WARM_REL_TOL * max(1.0, abs(obj64)),
              f"warm tick {k}: objective {obj} vs host recount {obj64}")
        check(lb <= obj, f"warm tick {k}: bound {lb} > objective {obj}")
        warm.append(dict(wall_s=wall, objective=obj, objective_host_f64=obj64,
                         carried_lower_bound=lb,
                         rounds=int(wres.rounds)))
    out = dict(instance=dict(h=h, w=w, nodes=inst.num_nodes,
                             pad_edges=inst.num_edges),
               bucket=list(s.bucket), patch=dict(zip(
                   ("reweights", "inserts", "deletes"), sizes)),
               cold_open_s=cold_s, exact_tick_s=exact_s,
               cold_objective=float(cold_open["objective"]),
               cold_lower_bound=float(cold_open["lower_bound"]),
               exact_objective=float(res.objective),
               exact_lower_bound=float(res.lower_bound), warm_ticks=warm,
               delta_filler_slots=eng.stats.n_delta_filler_slots)
    log(f"  session {h}x{w} (bucket {list(s.bucket)}): cold open "
        f"{cold_s:.3f} s, exact tick {exact_s:.3f} s (equal to the cold "
        f"solve, objective {out['exact_objective']}), warm ticks "
        f"{[round(x['wall_s'], 3) for x in warm]} s, objectives "
        f"{[x['objective'] for x in warm]}, carried bounds "
        f"{[x['carried_lower_bound'] for x in warm]} [{CARD_NAME}]")
    return out


def phase_serve(rehearse: bool, max_neg: int) -> dict:
    t0 = time.perf_counter()
    out = dict(stream=phase_serve_stream(rehearse),
               session=phase_serve_session(rehearse, max_neg))
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 7 took {out['phase_s']:.1f} s [{CARD_NAME}]")
    return out


# ---------------------------------------------------------------------------
# Phase 8: solve traces, the sequential baselines, streamed ingest and the
# per-phase roofline of a round
# ---------------------------------------------------------------------------

# (c) Table 1's grids: the small one (every baseline, ICP included) and
# the one GAEC also runs on beside RAMA (the main path's); (d) the ingest
# chunk in edges; (e) the arch cells' dims in a rehearsal (the card runs
# the cells' own)
TABLE1 = {"card": ((128, 128), (512, 1024)), "rehearse": ((20, 20), (20, 20))}
INGEST_CHUNK = {"card": 1 << 18, "rehearse": 64}
LONG_ROUNDS = 64        # (c): max_rounds for the run-until-done setting
RAMA_REHEARSE = {"pd_round_sm": dict(n_nodes=64, n_edges=320),
                 "pd_round_lg": dict(n_nodes=144, n_edges=700),
                 "mp_sweep_1m": dict(n_edges=3000, n_triangles=4099)}


def traced_solve(inst, **kw):
    sync()
    t0 = time.perf_counter()
    res, tr = api.solve(inst, device=DEV, trace=True, **kw)
    sync()
    return res, tr, time.perf_counter() - t0


def phase8_traced_main(main: dict) -> dict:
    """(a) The main path traced: bit-equal to phase 3's untraced result,
    with the same launches and host syncs; the trace's bound rows equal
    the result's history and its last objective the result's."""
    inst, want = main["_inst"], main["_result"]
    reset_counters()
    res, tr, first_s = traced_solve(inst)
    launches = all_launches()
    r = host(res)
    diff = same_result(r, want)
    check(not diff, f"traced main path != phase 3's solve in {diff}")
    check(launches == main["launches"] | {"flash_attention": 0,
                                          "contract_matmul": 0},
          f"traced main path launched {launches}, the untraced "
          f"{main['launches']}")
    R = int(r["rounds"])
    check(int(tr.rounds) == R, f"trace rounds {int(tr.rounds)} != {R}")
    lb = tr.lower_bound.cpu().numpy()
    check(np.array_equal(lb[:R], r["lb_history"][:R]),
          "trace lower_bound rows != the result's lb_history")
    check(float(tr.objective[R - 1]) == float(r["objective"]),
          f"trace's last objective {float(tr.objective[R - 1])} != "
          f"{float(r['objective'])}")
    walls = [traced_solve(inst)[2] for _ in range(3)]
    sites = count_syncs(lambda: api.solve(inst, device=DEV, trace=True))
    syncs = sum(sites.values())
    summ = summarize(tr)
    untraced = main["wall_s_median"]
    out = dict(rounds=R, first_call_s=first_s, wall_s=walls,
               wall_s_median=statistics.median(walls),
               untraced_wall_s_median=untraced,
               overhead=statistics.median(walls) / untraced - 1,
               host_syncs=syncs, launches=launches, summary=summ)
    for row in summ["per_round"]:
        log("  round {round}: LB {lower_bound}, objective {objective}, "
            "cycles {n_cycles}, contracted {n_contracted}, clusters "
            "{n_clusters}, MP gain {mp_improvement}".format(**row))
    log(f"  traced main path: gap {summ.get('gap')}, wall "
        f"{out['wall_s_median']:.3f} s against untraced {untraced:.3f} s "
        f"(medians of 3; overhead {out['overhead']:+.4f}), host syncs "
        f"{syncs} {dict(sites.most_common())}, launches {launches} "
        f"[{CARD_NAME}]")
    # the port's own sync sites must match the untraced solve's one for
    # one (a sync outside the port, e.g. a one-time lazy init in torch,
    # is printed but not held)
    own = {k: n for k, n in sites.items() if not k.startswith("outside")}
    want = {k: n for k, n in main["host_sync_sites"].items()
            if not k.startswith("outside")}
    check(own == want, f"traced main path: the port's host syncs {own}, "
          f"the untraced solve's {want}")
    return out


def phase8_traced_modes(h: int, w: int, max_neg: int) -> dict:
    """(b) Modes p, pd+ and d traced on both data paths, each bit-equal to
    its untraced solve."""
    inst = graph.grid_instance(h, w, seed=0,
                               pad_edges=grid_edges(h, w) + 4 * max_neg,
                               device=DEV)
    out = {}
    for mode in ("p", "pd+", "d"):
        for impl in ("dense", "sparse"):
            ref = host(api.solve(inst, mode=mode, graph_impl=impl,
                                 device=DEV))
            res, tr, _ = traced_solve(inst, mode=mode, graph_impl=impl)
            diff = same_result(host(res), ref)
            check(not diff, f"traced {mode} {impl} != untraced in {diff}")
            out[f"{mode} {impl}"] = dict(rounds=int(tr.rounds),
                                         summary=summarize(tr))
            log(f"  traced {mode} {impl}: bit-equal, {int(tr.rounds)} "
                f"rounds, final row {summarize(tr)['per_round'][-1]}")
    return out


def timed_host(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def check_labels(inst, labels: np.ndarray, what: str) -> float:
    """A labelling is a partition of the valid nodes into clusters 0..k-1,
    and ``baselines.objective`` equals a float64 recount within 1e-5."""
    n = int(inst.node_valid.sum())
    lab = labels[:n]
    k = len(np.unique(lab))
    check(lab.min() == 0 and lab.max() == k - 1,
          f"{what}: labels are not a partition (ids 0..{k - 1})")
    u, v, c = graph.to_host_edges(inst)
    obj64 = float(c.astype(np.float64)[labels[u] != labels[v]].sum())
    obj = baselines.objective(inst, labels)
    check(abs(obj - obj64) <= 1e-5 * max(1.0, abs(obj64)),
          f"{what}: objective {obj} vs float64 recount {obj64}")
    return obj


def rama_rows(inst, rows: dict, main_res=None):
    """RAMA pd on the card at the default preset (phase 3's result on the
    main path) and with max_rounds = 64."""
    long_cfg = api.SolverConfig(max_rounds=LONG_ROUNDS)
    for name, kw, given in (("RAMA pd (max_rounds 16)", {}, main_res),
                            (f"RAMA pd (max_rounds {LONG_ROUNDS})",
                             dict(config=long_cfg), None)):
        if given is None:
            res, wall = timed_solve(inst, **kw)
            r = host(res)
        else:
            r, wall = given
        obj = check_labels(inst, r["labels"], name)
        check(rel_close(obj, r["objective"], 1e-4),
              f"{name}: objective {r['objective']} vs host {obj}")
        rows[name] = dict(objective=float(r["objective"]),
                          lower_bound=float(r["lower_bound"]),
                          rounds=int(r["rounds"]), wall_s=wall,
                          device=str(DEV))


def check_bounds(rows: dict, what: str):
    """Every lower bound on an instance is <= every feasible objective."""
    lbs = {k: r["lower_bound"] for k, r in rows.items()
           if r.get("lower_bound") is not None}
    objs = {k: r["objective"] for k, r in rows.items()
            if r.get("objective") is not None}
    for kl, lb in lbs.items():
        for ko, obj in objs.items():
            check(lb <= obj + 1e-5 * max(1.0, abs(obj)),
                  f"{what}: {kl} bound {lb} > {ko} objective {obj}")
    for r in rows.values():
        if r.get("objective") is not None:
            r["gap_to_best_bound"] = r["objective"] - max(lbs.values())


def phase8_table1(small, large, main: dict) -> dict:
    """(c) Table 1 on the card: the sequential baselines on the host and
    RAMA on the card, on the small grid and the main path's."""
    out = {}
    for (h, w), big in ((small, False), (large, True)):
        inst = main["_inst"] if big else graph.grid_instance(
            h, w, seed=0, device=DEV)
        rows = {}
        algos = [("GAEC", baselines.gaec)]
        if not big:
            algos += [("GEF", baselines.gef), ("BEC", baselines.bec)]
        for name, fn in algos:
            lab, t = timed_host(fn, inst)
            rows[name] = dict(objective=check_labels(inst, lab, name),
                              wall_s=t, device="host")
            if name == "GAEC":
                gaec_labels = lab
        if not big:
            lab, t = timed_host(baselines.greedy_join_local_search, inst,
                                gaec_labels)
            rows["GAEC + local search"] = dict(
                objective=check_labels(inst, lab, "local search"),
                wall_s=t, device="host")
            lb, t = timed_host(baselines.icp, inst)
            rows["ICP"] = dict(lower_bound=lb, wall_s=t, device="host")
        main_res = (main["_result"], main["wall_s_median"]) if big else None
        rama_rows(inst, rows, main_res)
        key = f"{h}x{w}" + (" (main path)" if big else "")
        check_bounds(rows, key)
        out[key] = rows
        for name, r in rows.items():
            log(f"  Table 1 {key} {name}: " + ", ".join(
                f"{k} {v}" for k, v in r.items()) + f" [{CARD_NAME}]")
    return out


def phase8_ingest(main: dict, chunk: int) -> dict:
    """(d) The main path's grid streamed back in through
    ``make_instance_streamed``: leaves equal the generator's, the solve
    equals phase 3's, and the host holds one buffer and one chunk."""
    inst = main["_inst"]
    u, v, c = graph.to_host_edges(inst)
    chunks = [(u[i:i + chunk], v[i:i + chunk], c[i:i + chunk])
              for i in range(0, len(u), chunk)]
    sync()
    t0 = time.perf_counter()
    got, stats = graph.make_instance_streamed(
        iter(chunks), inst.num_nodes, pad_edges=inst.num_edges, device=DEV)
    sync()
    ingest_s = time.perf_counter() - t0
    same = [f for f, a, b in zip(inst._fields, got, inst)
            if not torch.equal(a, b)]
    check(not same, f"streamed instance != the generator's in {same}")
    check(stats.peak_host_elems == inst.num_edges + chunk,
          f"streamed ingest peak {stats.peak_host_elems} host slots, want "
          f"{inst.num_edges + chunk}")
    r = host(api.solve(got, device=DEV))
    diff = same_result(r, main["_result"])
    check(not diff, f"the streamed instance solves differently in {diff}")
    nbytes = sum(t.numel() * t.element_size() for t in got[:4])
    copy_ms = float("nan")
    if DEV.type == "cuda":      # the host-to-device copy alone, pinned
        pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        copy_ms = cuda_ms(lambda: pinned.to(DEV, non_blocking=True), 5, 1)
    out = dict(chunk=chunk, n_chunks=stats.n_chunks, n_edges=stats.n_edges,
               peak_host_elems=stats.peak_host_elems, ingest_s=ingest_s,
               bytes=nbytes, ingest_gb_per_s=nbytes / ingest_s / 1e9,
               copy_ms=copy_ms, copy_gb_per_s=nbytes / copy_ms / 1e6)
    log(f"  streamed ingest: {stats.n_edges} edges in {stats.n_chunks} "
        f"chunks of {chunk}, peak {stats.peak_host_elems} host slots, "
        f"{ingest_s:.3f} s ({out['ingest_gb_per_s']:.3f} GB/s of edge "
        f"arrays, host fill included); the pinned copy alone "
        f"{copy_ms:.3f} ms ({out['copy_gb_per_s']:.2f} GB/s); solve "
        f"bit-equal [{CARD_NAME}]")
    return out


def log_profile(what: str, prof: dict, spans: dict, rounds: int):
    """One line a phase: the profiled round 0 beside the solve's profiled
    span of that phase (summed over its ``rounds`` rounds)."""
    for name, rec in prof["phases"].items():
        span = (spans or {}).get(f"repro.{name}", {})
        log(f"  roofline {what} {name}: wall {rec['wall_s'] * 1e3:.3f} ms, "
            f"{rec['bytes_accessed']} B, {rec['flops']} flops "
            f"(kernels {rec['kernel_bytes']} B, {rec['kernel_flops']} ops, "
            f"launches {rec['kernel_launches']}; {rec['torch_ops']} torch "
            f"ops), {rec['dominant']}-bound, roofline "
            f"{rec['roofline_s'] * 1e3:.4f} ms, share {rec['bound_share']}"
            f"; the solve's device span over its {rounds} rounds "
            f"{span.get('device_ms')} ms, busy {span.get('device_busy_ms')}"
            f" ms [{CARD_NAME}]")


def rama_cell_inputs(cell, gen):
    """Inputs of a rama-multicut cell from a seed: a grid of n_nodes padded
    to n_edges for a round, random triangles over random costs for MP."""
    d = cell.dims
    if cell.kind == "solver":
        side = int(round(d["n_nodes"] ** 0.5))
        return tuple(graph.grid_instance(side, side, seed=0,
                                         pad_edges=d["n_edges"],
                                         device=DEV))
    E, T = d["n_edges"], d["n_triangles"]
    tri = torch.randint(0, E, (T, 3), generator=gen, device=DEV,
                        dtype=torch.int32)
    return (torch.randn(E, generator=gen, device=DEV),
            torch.ones(E, dtype=torch.bool, device=DEV), tri,
            torch.ones(T, dtype=torch.bool, device=DEV))


def phase8_roofline(main: dict, dense: dict, dense_grid, gen,
                    rehearse: bool) -> dict:
    """(e) ``profile_solve_round`` on the main path's grid (sparse) and on
    phase 6's grid on the dense path, with the card's Hardware entry; then
    each rama-multicut cell's step, timed, with its model-FLOPs rate."""
    card = CARD_NAME.split(",")[0].strip()
    check(DEV.type != "cuda" or card == roofline.HW.name,
          f"the card is {card!r}, the roofline's Hardware entry "
          f"{roofline.HW.name!r}")
    out = {}
    prof = roofline.profile_solve_round(main["_inst"], api.SolverConfig())
    log_profile("main path (sparse)", prof,
                main.get("profile", {}).get("phases"), main["rounds"])
    out["main"] = prof
    out["round_launches"] = {
        k: sum(rec["kernel_launches"][k] for rec in prof["phases"].values())
        for k in ("triangle_mp", "cycle_intersect")}
    h, w = dense_grid
    inst = graph.grid_instance(h, w, seed=0,
                               pad_edges=grid_edges(h, w) + 4 * 256,
                               device=DEV)
    prof = roofline.profile_solve_round(
        inst, api.SolverConfig(graph_impl="dense"))
    log_profile(f"{h}x{w} dense", prof, dense.get("profile", {}).get(
        "phases"), dense.get("runs", {}).get("pd", {}).get(
        "dense", {}).get("rounds"))
    out["dense"] = prof
    arch = get_arch("rama-multicut")
    cells = {}
    for name in ("pd_round_sm", "pd_round_lg", "mp_sweep_1m"):
        cell = arch.shapes[name]
        if rehearse:
            cell = dataclasses.replace(cell, dims=RAMA_REHEARSE[name])
        args = rama_cell_inputs(cell, gen)
        step = arch.step_fn(cell)
        reset_counters()
        out_t = step(*args)
        sync()
        launches = all_launches()
        check(all(torch.isfinite(t).all() for t in out_t
                  if t.is_floating_point()),
              f"{name}: non-finite outputs")
        check(DEV.type != "cuda" or name != "mp_sweep_1m"
              or launches["triangle_mp"] > 0,
              f"{name} did not launch triangle_mp: {launches}")
        ms = cuda_ms(lambda: step(*args), 5, 1)
        flops = arch.model_flops(cell)
        cells[name] = dict(dims=cell.dims, launches=launches, ms=ms,
                           model_flops=flops,
                           model_tflop_per_s=flops / ms / 1e9)
        log(f"  rama-multicut {name} {cell.dims}: {ms:.4f} ms (median of 5),"
            f" model FLOPs {flops:.4g} -> {flops / ms / 1e9:.4f} TFLOP/s, "
            f"launches {launches} [{CARD_NAME}]")
    out["cells"] = cells
    return out


def phase_trace(main: dict, dense: dict, gen, rehearse: bool) -> dict:
    t0 = time.perf_counter()
    max_neg = api.SolverConfig().max_neg
    key = "rehearse" if rehearse else "card"
    dense_grid = DENSE_GRID[key]
    out = dict(traced_main=phase8_traced_main(main))
    out["traced_modes"] = phase8_traced_modes(*dense_grid, max_neg)
    out["table1"] = phase8_table1(*TABLE1[key], main)
    out["ingest"] = phase8_ingest(main, INGEST_CHUNK[key])
    out["roofline"] = phase8_roofline(main, dense, dense_grid, gen, rehearse)
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 8 took {out['phase_s']:.1f} s [{CARD_NAME}]")
    return out


# ---------------------------------------------------------------------------
# Phase 9: the edge-range-sharded solve and the block decomposition
# ---------------------------------------------------------------------------

P9 = {"card": dict(main=(512, 1024), pair=(128, 128),
                   dist_dims=None),
      "rehearse": dict(main=(20, 20), pair=(12, 12),
                       dist_dims=dict(blk_nodes=64, blk_edges=320,
                                      boundary_edges=256))}
BLOCKS = dict(n=400, p=0.05, seed=3, pad_edges=8192, pad_nodes=512,
              n_blocks=8, blk_nodes=64, blk_edges=1024, max_neg=64,
              quotient_pad=4096)
SHARDED_REL_TOL = 1e-5          # sharded vs replicated objective / bound
INTS9 = ("labels", "rounds", "n_contracted", "n_clusters")

# one rank of (b): the 128x128 grid at S = 2 over gloo on the parent's
# card; loads the kernels phase 1 built, builds none
P9_RANK = """
import dataclasses, time
import numpy as np, torch
import torch.distributed as dist
from repro_torch.launch.ranks import process_group
from repro_torch import api, roofline
from repro_torch.core import graph
from repro_torch.kernels.cycle_intersect import ops as isect_ops
from repro_torch.kernels.triangle_mp import ops as sweep_ops
DEV, (H, W), OUT = torch.device(%(dev)r), %(grid)r, %(out)r
def sync():
    if DEV.type == "cuda":
        torch.cuda.synchronize()
out = {}
with process_group("gloo") as (rank, world):
    inst = graph.grid_instance(H, W, seed=0, pad_edges=%(pad)d, device=DEV)
    cfg = dataclasses.replace(api.get_preset("pd-state-sharded").config,
                              state_shards=2)
    sweep_ops.launches = isect_ops.launches = 0
    api.solve(inst, config=cfg, device=DEV)         # warm-up, counted
    launches = [sweep_ops.launches, isect_ops.launches]
    sync()
    t0 = time.perf_counter()
    res = api.solve(inst, config=cfg, device=DEV)
    sync()
    wall = time.perf_counter() - t0
    res_t, tr = api.solve(inst, config=cfg, trace=True, device=DEV)
    out.update({k: x.cpu().numpy() for k, x in res._asdict().items()})
    out.update({"traced/" + k: x.cpu().numpy()
                for k, x in res_t._asdict().items()})
    out.update({"trace/" + k: x.cpu().numpy()
                for k, x in tr._asdict().items()})
    # phase 10 (c): the sharded round's roofline profile at S = 2
    prof = roofline.profile_solve_round(inst, cfg)
    for ph, rec in prof["phases"].items():
        for k, x in rec.items():
            if isinstance(x, (bool, int, float)):
                out[f"profile/{ph}/{k}"] = np.array(x)
out["group_destroyed"] = np.array(not dist.is_initialized())
np.savez(f"{OUT}.rank{rank}.npz", launches=np.array(launches),
         wall=np.array(wall), **out)
"""


def case_keys(*case_sets: dict) -> dict:
    """The shapes these cases held each kernel at: (T, edges) of each
    triangle_mp case, (R, W, Wj) of each cycle_intersect case."""
    keys = {"triangle_mp": set(), "cycle_intersect": set()}
    for cases in case_sets:
        keys["triangle_mp"] |= {(c["shape"][0], c["edges"])
                                for c in cases["triangle_mp"]}
        keys["cycle_intersect"] |= {
            (c["shape"][0][0], c["shape"][0][1], c["shape"][1][1])
            for c in cases["cycle_intersect"]}
    return keys


def shape_cases(shapes: dict, covered: dict, E: int, gen, label: str,
                timed: bool = True) -> dict:
    """Hold each kernel against its plain version at the shapes a path
    gave it (``shapes``, as the wrappers count them) that no key of
    ``covered`` (see ``case_keys``) held it at."""
    out = {"triangle_mp": [], "cycle_intersect": []}
    for T in sorted(set(shapes["triangle_mp"])):
        if (T, E) not in covered["triangle_mp"]:
            out["triangle_mp"].append(phase_case(T, E, T // 8, gen, label,
                                                 timed=timed))
    for (R, W, Wj) in sorted(set(shapes["cycle_intersect"])
                             - covered["cycle_intersect"]):
        out["cycle_intersect"].append(intersect_case(R, W, Wj, gen,
                                                     timed=timed))
    return out


def check_phase_launches(launches: dict, shapes: dict, rounds: int,
                         what: str):
    """On the card, the triangle_mp launches are those the counted MP
    phases make, and there is one MP phase per solver round."""
    check(DEV.type != "cuda" or launches["cycle_intersect"] > 0,
          f"{what} did not launch cycle_intersect: {launches}")
    check(DEV.type != "cuda" or (
        launches["triangle_mp"] == phase_launches(shapes["triangle_mp"])
        and sum(shapes["triangle_mp"].values()) == rounds),
          f"{what}: {launches['triangle_mp']} triangle_mp launches for MP "
          f"phases {shapes['triangle_mp']} in {rounds} rounds")


def phase9_one_rank(h: int, w: int, main: dict, gen) -> dict:
    """(a) The main path's grid through ``preset="pd-state-sharded"`` on
    the one-rank group, against the replicated sparse solve of the same
    config."""
    E = grid_edges(h, w)
    inst = graph.grid_instance(h, w, seed=0, pad_edges=graph.round_up_edges(E),
                               device=DEV)
    preset = api.get_preset("pd-state-sharded")
    rep_cfg = dataclasses.replace(preset.config, state_shards=0)
    S = dist_mod.resolve_state_shards(preset.config.state_shards)
    check(S == 1, f"pd-state-sharded resolved to {S} shards on one rank")

    def peak_of(fn):
        if DEV.type == "cuda":
            sync()
            torch.cuda.reset_peak_memory_stats()
        fn()
        sync()
        return torch.cuda.max_memory_allocated() if DEV.type == "cuda" \
            else 0

    reset_counters()
    res, first_s = timed_solve(inst, preset="pd-state-sharded")
    launches = all_launches()
    shapes = path_shapes()
    r = host(res)
    rounds = int(r["rounds"])
    check_phase_launches(launches, shapes, rounds, "the sharded solve")
    check(launches["flash_attention"] == 0
          and launches["contract_matmul"] == 0,
          "the sharded solve launched the attention or contraction kernel")
    rep, rep_first = timed_solve(inst, config=rep_cfg)
    rr = host(rep)
    diff = [k for k in INTS9 if not np.array_equal(r[k], rr[k])]
    check(not diff, f"sharded != replicated in {diff}")
    for k in ("objective", "lower_bound"):
        check(rel_close(r[k], rr[k], SHARDED_REL_TOL),
              f"sharded {k} {r[k]} vs replicated {rr[k]}")
    obj64 = check_solution(inst, r, "sharded main path")
    check(rel_close(r["objective"], obj64, SHARDED_REL_TOL),
          f"sharded objective {r['objective']} vs float64 recount {obj64}")
    res_t, tr = api.solve(inst, preset="pd-state-sharded", trace=True,
                          device=DEV)
    diff = same_result(host(res_t), r)
    check(not diff, f"traced sharded solve != untraced in {diff}")
    check(tuple(tr.shard_edges.shape) == (preset.config.max_rounds, 1),
          f"shard rows {tuple(tr.shard_edges.shape)}, want width 1")
    walls = [timed_solve(inst, preset="pd-state-sharded")[1]
             for _ in range(3)]
    rep_walls = [timed_solve(inst, config=rep_cfg)[1] for _ in range(3)]
    sites = count_syncs(lambda: api.solve(inst, preset="pd-state-sharded",
                                          device=DEV))
    rep_sites = count_syncs(lambda: api.solve(inst, config=rep_cfg,
                                              device=DEV))
    peak = peak_of(lambda: api.solve(inst, preset="pd-state-sharded",
                                     device=DEV))
    rep_peak = peak_of(lambda: api.solve(inst, config=rep_cfg, device=DEV))
    prof = profile_solve(inst, preset="pd-state-sharded")
    med, rep_med = statistics.median(walls), statistics.median(rep_walls)
    out = dict(
        instance=dict(h=h, w=w, nodes=inst.num_nodes, edges=E,
                      pad_edges=inst.num_edges),
        shards=S, rounds=rounds, objective=float(r["objective"]),
        objective_host_f64=obj64, lower_bound=float(r["lower_bound"]),
        replicated_objective=float(rr["objective"]),
        replicated_lower_bound=float(rr["lower_bound"]),
        n_contracted=r["n_contracted"].tolist(), launches=launches,
        shapes=shape_record(shapes), first_call_s=first_s, replicated_first_call_s=rep_first,
        wall_s=walls, wall_s_median=med, replicated_wall_s=rep_walls,
        replicated_wall_s_median=rep_med, wall_ratio=med / rep_med,
        host_syncs=sum(sites.values()),
        host_sync_sites=dict(sites.most_common()),
        replicated_host_syncs=sum(rep_sites.values()),
        replicated_host_sync_sites=dict(rep_sites.most_common()),
        peak_bytes=peak, replicated_peak_bytes=rep_peak, profile=prof,
        trace=summarize(tr))
    log(f"  sharded main path (S = {S}, one-rank group): {rounds} rounds, "
        f"objective {out['objective']} (replicated {out['replicated_objective']}"
        f", host f64 {obj64}), bound {out['lower_bound']} (replicated "
        f"{out['replicated_lower_bound']}); labels and histories equal; "
        f"launches {launches}, MP phases {shapes['triangle_mp']}")
    log(f"  wall {med:.3f} s sharded vs {rep_med:.3f} s replicated (medians "
        f"of 3, ratio {med / rep_med:.3f}); host syncs "
        f"{out['host_syncs']} {out['host_sync_sites']} vs "
        f"{out['replicated_host_syncs']} {out['replicated_host_sync_sites']}"
        f"; peak {peak / 2**20:.1f} vs {rep_peak / 2**20:.1f} MiB "
        f"[{CARD_NAME}]")
    if prof:
        busy = prof["device_busy_ms"] / 1e3
        log(f"  profiled sharded solve: device busy {busy:.3f} s of "
            f"{prof['wall_ms'] / 1e3:.3f} s wall; phases {prof['phases']}; "
            f"kernels {prof['kernels']}; top "
            f"{prof['top_device_kernels'][:6]} [{CARD_NAME}]")
    main_keys = {"triangle_mp": {(T, main["instance"]["pad_edges"])
                                 for T in main["main_shapes"]["triangle_mp"]},
                 "cycle_intersect": set(main["main_shapes"][
                     "cycle_intersect"])}
    out["cases"] = shape_cases(shapes, main_keys, inst.num_edges, gen,
                               "sharded path")
    return out


def phase9_two_ranks(h: int, w: int) -> dict:
    """(b) Two processes on the one card over gloo, S = 2, against S = 1
    in this process."""
    pad = graph.round_up_edges(grid_edges(h, w))
    inst = graph.grid_instance(h, w, seed=0, pad_edges=pad, device=DEV)
    cfg = dataclasses.replace(api.get_preset("pd-state-sharded").config,
                              state_shards=1)
    one = host(api.solve(inst, config=cfg, device=DEV))
    base = ROOT / "chiprun_out" / "phase9_two_ranks"
    base.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    t0 = time.perf_counter()
    ranks.spawn(P9_RANK % dict(dev=str(DEV), grid=(h, w), out=str(base),
                               pad=pad),
                world=2, store=f"{base}.store", env=env, timeout=600)
    spawn_s = time.perf_counter() - t0
    out = dict(instance=dict(h=h, w=w, pad_edges=pad), spawn_s=spawn_s,
               ranks=[])
    for rank in range(2):
        got = dict(np.load(f"{base}.rank{rank}.npz"))
        for prefix in ("", "traced/"):
            diff = [k for k in one if not np.array_equal(got[prefix + k],
                                                         one[k])]
            check(not diff, f"rank {rank}: S = 2 {prefix or 'untraced '}"
                  f"!= S = 1 in {diff}")
        check(bool(got["group_destroyed"]),
              f"rank {rank} exited with its process group alive")
        n_mp, n_isect = (int(x) for x in got["launches"])
        check(DEV.type != "cuda" or (n_mp > 0 and n_isect > 0),
              f"rank {rank} launched triangle_mp {n_mp}, cycle_intersect "
              f"{n_isect} times")
        R = int(got["trace/rounds"])
        rows = {k: got["trace/" + k][:R].tolist()
                for k in ("shard_edges", "shard_topk", "shard_halo")}
        prof = {}
        for k, x in got.items():
            if k.startswith("profile/"):
                ph, key = k.split("/")[1:]
                prof.setdefault(ph, {})[key] = x.item()
        out["ranks"].append(dict(wall_s=float(got["wall"]),
                                 launches=dict(triangle_mp=n_mp,
                                               cycle_intersect=n_isect),
                                 rounds=R, profile=prof, **rows))
        log(f"  two ranks over gloo, rank {rank}: bit-identical to S = 1 "
            f"({R} rounds), wall {float(got['wall']):.3f} s, launches "
            f"triangle_mp {n_mp}, cycle_intersect {n_isect}; per-shard "
            f"rows edges {rows['shard_edges']}, top-k {rows['shard_topk']},"
            f" halo {rows['shard_halo']} [{CARD_NAME}]")
    return out


def phase9_blocks(group, rehearse: bool, gen) -> dict:
    """(c) The block decomposition on the one-rank group: the distributed
    round over 8 blocks, the quotient solved, the bound below the
    replicated objective; then the dist_pd cell's step at its dims."""
    b = BLOCKS
    inst = graph.random_instance(b["n"], b["p"], seed=b["seed"],
                                 pad_edges=b["pad_edges"],
                                 pad_nodes=b["pad_nodes"], device=DEV)
    parts = dist_mod.partition_instance(inst, b["n_blocks"],
                                        b["blk_nodes"], b["blk_edges"])
    keys = ("u", "v", "cost", "edge_valid", "node_valid", "boundary_cost")
    args = [torch.from_numpy(parts[k]).to(DEV) for k in keys]
    rnd = dist_mod.make_dist_pd_round(group, mp_iters=3,
                                      max_neg=b["max_neg"])
    reset_counters()
    sync()
    t0 = time.perf_counter()
    blocks = rnd(*args)
    sync()
    round_s = time.perf_counter() - t0
    launches = all_launches()
    lb = float(blocks[6])
    q, gl = dist_mod.merge_blocks_quotient(
        blocks[5].cpu().numpy(), parts["boundary_u"], parts["boundary_v"],
        parts["boundary_cost"], b["blk_nodes"], b["quotient_pad"],
        device=DEV)
    qres = host(api.solve(q, device=DEV))
    labels = qres["labels"][gl[:inst.num_nodes]]
    lifted = baselines.objective(inst, labels)
    rep = host(api.solve(inst, config=api.SolverConfig(max_neg=512),
                         device=DEV))
    check(np.isfinite(lb) and lb <= float(rep["objective"]) + 1e-3
          and lb <= lifted + 1e-3,
          f"block bound {lb} above the replicated objective "
          f"{float(rep['objective'])} or the quotient's {lifted}")
    arch = get_arch("rama-multicut")
    cell = arch.shapes["dist_pd"]
    if rehearse:
        cell = dataclasses.replace(cell, dims=P9["rehearse"]["dist_dims"])
    d = cell.dims
    side = int(round(d["blk_nodes"] ** 0.5))
    blk = graph.grid_instance(side, side, seed=0, pad_edges=d["blk_edges"],
                              device=DEV)
    cell_args = [t[None] for t in blk] + [torch.randn(
        d["boundary_edges"], generator=gen, device=DEV)]
    want = arch.abstract_inputs(cell)
    check([tuple(t.shape) for t in cell_args]
          == [tuple(want[k].shape) for k in keys],
          "dist_pd inputs do not have the cell's shapes")
    step = arch.step_fn(cell)
    cell_out = step(*cell_args)
    check(all(torch.isfinite(t).all() for t in cell_out
              if t.is_floating_point()), "dist_pd: non-finite outputs")
    ms = cuda_ms(lambda: step(*cell_args), 5, 1)
    flops = arch.model_flops(cell)
    out = dict(blocks=b["n_blocks"], round_s=round_s, launches=launches,
               lower_bound=lb, quotient_nodes=int(q.node_valid.sum()),
               quotient_objective=lifted,
               replicated_objective=float(rep["objective"]),
               cell=dict(dims=d, ms=ms, model_flops=flops,
                         model_tflop_per_s=flops / ms / 1e9))
    log(f"  block decomposition: {b['n_blocks']} blocks in {round_s:.3f} s "
        f"(launches {launches}), bound {lb} <= replicated objective "
        f"{out['replicated_objective']} and the quotient's "
        f"{lifted} ({out['quotient_nodes']} quotient nodes); dist_pd cell "
        f"{d}: {ms:.4f} ms (median of 5) [{CARD_NAME}]")
    return out


@contextlib.contextmanager
def one_rank_group(name: str):
    """An in-process process group of one rank (NCCL on the card, gloo in
    a rehearsal) over a FileStore under ``chiprun_out/``, destroyed when
    the block ends."""
    store = ROOT / "chiprun_out" / f"{name}.store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    kw = {}
    if DEV.type == "cuda":
        torch.cuda.set_device(0)
        kw["device_id"] = torch.device("cuda", 0)
    ranks.import_before_group()
    tdist.init_process_group("nccl" if DEV.type == "cuda" else "gloo",
                             store=tdist.FileStore(str(store), 1), rank=0,
                             world_size=1, **kw)
    try:
        yield tdist.group.WORLD
    finally:
        tdist.destroy_process_group()


def phase_sharded(main: dict, gen, rehearse: bool) -> dict:
    """Phase 9: (a) and (c) on a one-rank process group (NCCL on the card,
    gloo in a rehearsal), (b) in two child processes; the group is
    destroyed before the phase returns."""
    t0 = time.perf_counter()
    key = "rehearse" if rehearse else "card"
    with one_rank_group("phase9") as group:
        out = dict(one_rank=phase9_one_rank(*P9[key]["main"], main, gen))
        out["two_ranks"] = phase9_two_ranks(*P9[key]["pair"])
        out["blocks"] = phase9_blocks(group, rehearse, gen)
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 9 took {out['phase_s']:.1f} s [{CARD_NAME}]")
    return out


# ---------------------------------------------------------------------------
# Phase 10: separation and batch sharding over copies of the one card, and
# the sharded round's roofline profile
# ---------------------------------------------------------------------------

P10_SHARDS = (1, 2, 4)
P10_BATCH = {"card": (128, 128), "rehearse": (16, 16)}


@contextlib.contextmanager
def copies_of_card(S: int):
    """S copies of the one card stand in for S cards: while the block
    runs, ``torch.cuda.device_count`` says S and the shard device map
    sends every shard to the instance's own device. A run on S real
    cards would place shard r on ``cuda:r``."""
    count, devices = torch.cuda.device_count, dist_mod.shard_devices
    torch.cuda.device_count = lambda: S
    dist_mod.shard_devices = lambda shards, device: \
        [torch.device(device)] * shards
    try:
        yield
    finally:
        torch.cuda.device_count = count
        dist_mod.shard_devices = devices


def phase10_separation(main: dict, covered: dict, gen) -> dict:
    """(a) The main path's instance at ``pd-sharded``: as resolved on the
    one card (S = 1, the warm-up), then S = 2 and 4 over copies of the
    card, against ``pd-chunked`` (the same config without shards) and
    phase 3's default solve: bit-equal everywhere. Per S: one timed run
    with the launch counters zeroed just before and read just after (one
    triangle_mp phase per round, its launches those of the counted
    phases), and the host syncs of one more run. Then each kernel is held
    against its plain version at every shape these runs gave it that no
    key of ``covered`` held it at."""
    inst = main["_inst"]
    S1 = dist_mod.resolve_separation_shards(
        api.get_preset("pd-sharded").config.separation_shards)
    check(S1 == 1, f"pd-sharded resolved to {S1} shards on one card")
    log(f"  pd-sharded asks for 4 shards; clamped to {S1} on the one card; "
        f"S = 2 and 4 run over copies of cuda:0 (device count and shard "
        f"device map replaced)")
    sites1 = count_syncs(lambda: api.solve(inst, preset="pd-sharded",
                                           device=DEV))     # warm-up
    chunked = host(api.solve(inst, preset="pd-chunked", device=DEV))
    diff = same_result(chunked, main["_result"])
    check(not diff, f"pd-chunked != phase 3's default solve in {diff}")
    out, every = {}, {"triangle_mp": {}, "cycle_intersect": {}}
    for S in P10_SHARDS:
        with copies_of_card(S) if S > 1 else contextlib.nullcontext():
            reset_counters()
            res, wall = timed_solve(inst, preset="pd-sharded")
            launches, shapes = all_launches(), path_shapes()
            sites = sites1 if S == 1 else count_syncs(
                lambda: api.solve(inst, preset="pd-sharded", device=DEV))
        r = host(res)
        diff = same_result(r, chunked)
        check(not diff, f"pd-sharded at S = {S} != pd-chunked in {diff}")
        check(launches["flash_attention"] == 0
              and launches["contract_matmul"] == 0,
              f"S = {S}: the attention or contraction kernel launched")
        check_phase_launches(launches, shapes, int(r["rounds"]),
                             f"pd-sharded at S = {S}")
        merge_shapes(every, shapes)
        out[S] = dict(wall_s=wall, host_syncs=sum(sites.values()),
                      host_sync_sites=dict(sites.most_common(6)),
                      launches=dict(triangle_mp=launches["triangle_mp"],
                                    cycle_intersect=launches[
                                        "cycle_intersect"]),
                      shapes=shape_record(shapes))
        log(f"  pd-sharded S = {S}: bit-equal to pd-chunked and phase 3 "
            f"({int(r['rounds'])} rounds, objective {float(r['objective'])}"
            f", bound {float(r['lower_bound'])}); wall {wall:.3f} s, host "
            f"syncs {out[S]['host_syncs']}, launches {out[S]['launches']}, "
            f"{len(shapes['cycle_intersect'])} cycle_intersect shapes "
            f"[{CARD_NAME}]")
    out["cases"] = shape_cases(every, covered, inst.num_edges, gen,
                               "separation-sharded path", timed=False)
    log_shape_cases("pd-sharded at S = 1, 2, 4", every, out["cases"])
    return out


def log_shape_cases(what: str, shapes: dict, cases: dict):
    log(f"  {what}: triangle_mp T {sorted(shapes['triangle_mp'])}, "
        f"cycle_intersect (R, W, Wj) {sorted(shapes['cycle_intersect'])}; "
        f"{len(cases['triangle_mp'])} + {len(cases['cycle_intersect'])} "
        f"of them new, each equal to its plain version (max abs err "
        f"{max([c['max_abs_err'] for v in cases.values() for c in v], default=0.0)})")


def phase10_batch(rehearse: bool, covered: dict, gen) -> dict:
    """(b) ``solve_batch`` of four grids at ``batch_shards`` 1, 2 and 4,
    bit-identical, each timed twice in the order 1, 2, 4, 4, 2, 1 (means);
    then phase 7's four tiles of that size served through a router with
    ``batch_shards=2``: each result equals ``api.solve`` of its padded
    instance, first-calls within the budget. Every run's triangle_mp
    launches are those of its counted MP phases; each kernel is then held
    against its plain version at every shape of these runs that no key of
    ``covered`` held it at."""
    h, w = P10_BATCH["rehearse" if rehearse else "card"]
    insts = [graph.grid_instance(h, w, seed=s, device=DEV)
             for s in range(4)]
    batch = api.stack_instances(insts)
    api.solve_batch(batch, device=DEV)                          # warm-up
    out, base, walls = {}, None, {S: [] for S in P10_SHARDS}
    every = {"triangle_mp": {}, "cycle_intersect": {}}
    for rep in range(2):
        for S in P10_SHARDS if rep == 0 else P10_SHARDS[::-1]:
            with copies_of_card(S) if S > 1 else contextlib.nullcontext():
                reset_counters()
                sync()
                t0 = time.perf_counter()
                res = api.solve_batch(batch, batch_shards=S, device=DEV)
                sync()
                walls[S].append(time.perf_counter() - t0)
                launches, shapes = all_launches(), path_shapes()
            r = host(res)
            base = r if base is None else base
            diff = same_result(r, base)
            check(not diff, f"solve_batch at batch_shards = {S} != 1 in "
                  f"{diff}")
            check_phase_launches(launches, shapes, int(r["rounds"].sum()),
                                 f"solve_batch at batch_shards = {S}")
            if rep == 0:
                merge_shapes(every, shapes)
            out[S] = dict(wall_s=walls[S],
                          wall_s_mean=statistics.mean(walls[S]),
                          launches=dict(
                              triangle_mp=launches["triangle_mp"],
                              cycle_intersect=launches["cycle_intersect"]),
                          shapes=shape_record(shapes))
    for S in P10_SHARDS:
        log(f"  solve_batch of 4 grids {h}x{w}, batch_shards = {S}: "
            f"bit-identical, wall {out[S]['wall_s_mean']:.3f} s (mean "
            f"of {[round(t, 3) for t in walls[S]]}), launches "
            f"{out[S]['launches']} [{CARD_NAME}]")
    tiles = [i for i in tile_stream(rehearse) if i.num_nodes == h * w]
    eng = solve_server.SolveEngine(
        router=solve_server.default_router(batch_shards=2),
        policy=solve_server.BucketPolicy(), batch_cap=SERVE_BATCH_CAP,
        device=DEV)
    with copies_of_card(2):
        reset_counters()
        results, tickets, wall = traced_stream(eng, tiles)
        launches, shapes = all_launches(), path_shapes()
        ladder = eng._ladder(tickets[0].route)
    check(DEV.type != "cuda" or (
        launches["cycle_intersect"] > 0 and launches["triangle_mp"]
        == phase_launches(shapes["triangle_mp"]) > 0),
          f"batch_shards=2 route: launches {launches} for MP phases "
          f"{shapes['triangle_mp']}")
    keys = {(t.bucket, eng._static_route.get(t.route, t.route))
            for t in tickets}
    budget = len({k[0] for k in keys}) * len({k[1] for k in keys}) * \
        len(ladder)
    st = eng.stats
    check(st.n_completed == len(tiles) and st.compiles <= budget,
          f"sharded route: {st.n_completed} served, {st.compiles} "
          f"first-calls over the budget {budget}")
    for inst, t, res in zip(tiles, tickets, results):
        ref = api.solve(solve_server.pad_instance(inst, t.bucket),
                        mode=t.route.mode, config=t.route.config,
                        backend=t.route.backend, device=DEV)
        diff = same_result(stripped(res, inst.num_nodes),
                           stripped(ref, inst.num_nodes))
        check(not diff, f"batch_shards=2 route != api.solve of the padded "
              f"{inst.num_nodes}-node tile in {diff}")
    out["engine"] = dict(tiles=len(tiles), wall_s=wall,
                         dispatches=st.n_dispatches, compiles=st.compiles,
                         compile_budget=budget, ladder=list(ladder),
                         launches=dict(
                             triangle_mp=launches["triangle_mp"],
                             cycle_intersect=launches["cycle_intersect"]),
                         shapes=shape_record(shapes))
    cases = shape_cases(every, covered, insts[0].num_edges, gen,
                        "batch-sharded path", timed=False)
    log_shape_cases(f"solve_batch of 4 grids {h}x{w}", every, cases)
    new = case_keys(cases)
    E_tile = solve_server.pad_instance(tiles[0], tickets[0].bucket).num_edges
    served = shape_cases(shapes, {k: covered[k] | new[k] for k in covered},
                         E_tile, gen, "batch-sharded route", timed=False)
    log_shape_cases("the batch_shards=2 route", shapes, served)
    out["cases"] = {k: cases[k] + served[k] for k in cases}
    log(f"  router with batch_shards=2: {len(tiles)} tiles {h}x{w} in "
        f"{wall:.3f} s, {st.n_dispatches} dispatches, ladder {list(ladder)}"
        f", first-calls {st.compiles} (budget {budget}); each equal to "
        f"api.solve of its padded tile [{CARD_NAME}]")
    return out


def log_sharded_profile(what: str, prof: dict):
    for ph, rec in prof["phases"].items():
        log(f"  {what} {ph}: wall {rec['wall_s'] * 1e3:.3f} ms, bytes "
            f"{rec['bytes_accessed']} (per device "
            f"{rec['bytes_accessed_per_device']}), flops {rec['flops']}, "
            f"collective bytes {rec['collective_bytes']} (this rank "
            f"{rec['rank_collective_bytes']}), {rec['dominant']}-bound, "
            f"share of bound {rec['bound_share']:.4f} [{CARD_NAME}]")


def phase10_profile(h: int, w: int, sharded: dict) -> dict:
    """(c) ``profile_solve_round`` of the main grid at ``pd-state-sharded``
    on a one-rank group (S = 1), per phase; then the S = 2 profile each
    of phase 9 (b)'s two gloo ranks took of its 128×128 grid."""
    inst = graph.grid_instance(
        h, w, seed=0, pad_edges=graph.round_up_edges(grid_edges(h, w)),
        device=DEV)
    cfg = api.get_preset("pd-state-sharded").config
    with one_rank_group("phase10"):
        prof = roofline.profile_solve_round(inst, cfg)
    check(prof["state_shards"] == 1 and all(
        rec["collective_bytes"] == 0 for rec in prof["phases"].values()),
          "the one-rank profile counted collective bytes")
    log_sharded_profile("one rank, main grid", prof)
    two = []
    for rank, rr in enumerate(sharded["two_ranks"]["ranks"]):
        p2 = rr["profile"]
        check(set(p2) == set(roofline.PHASES) and all(
            rec["collective_bytes_per_device"] > 0 for rec in p2.values()),
              f"rank {rank}'s S = 2 profile: {sorted(p2)}")
        for ph, rec in p2.items():
            log(f"  S = 2 rank {rank} {ph}: wall {rec['wall_s'] * 1e3:.3f} "
                f"ms, rank bytes {rec['rank_bytes_accessed']}, rank "
                f"collective bytes {rec['rank_collective_bytes']}, job "
                f"{rec['collective_bytes']}, share of bound "
                f"{rec['bound_share']:.4f} [{CARD_NAME}]")
        two.append(p2)
    return dict(one_rank=prof, two_ranks=two)


def phase_shards(main: dict, main_cases: dict, sharded: dict, gen,
                 rehearse: bool) -> dict:
    """Phase 10: (a) separation sharding, (b) batch sharding, (c) the
    sharded round's roofline profile. (a) and (b) hold the kernels at
    the shapes of their paths that phase 3's and phase 9's cases did not
    cover, and (b) also at those (a) did not."""
    t0 = time.perf_counter()
    covered = case_keys(main_cases, sharded["one_rank"]["cases"])
    out = dict(separation=phase10_separation(main, covered, gen))
    covered = case_keys(main_cases, sharded["one_rank"]["cases"],
                        out["separation"]["cases"])
    out.update(batch=phase10_batch(rehearse, covered, gen),
               profile=phase10_profile(*P9["rehearse" if rehearse
                                          else "card"]["main"], sharded))
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 10 took {out['phase_s']:.1f} s [{CARD_NAME}]")
    return out


# ---------------------------------------------------------------------------
# Phase 11: MoE serving (llama4-scout, grok-1) and the LM train step
# ---------------------------------------------------------------------------

# full width; depth cut to what one card's 80 GB holds beside the run
MOE_DEPTH = {"llama4-scout-17b-a16e": 4, "grok-1-314b": 2}
# (prefill S, decode context P0, decode steps after the first)
MOE_RUN = {"card": (8192, 8000, 4), "rehearse": (128, 100, 3)}
# (depth, S, steps, checkpoint after step): gemma2-9b, one local/global
# pair; S > its 4096 window, so the local layer's window masks
TRAIN_RUN = {"card": (2, 8192, 5, 3), "rehearse": (2, 48, 5, 3)}
# the registry's optimizer without its 100-step warm-up (which would hold
# the rate near 1e-5 for five steps)
TRAIN_OPT = dict(warmup_steps=0, schedule="constant")
# step-1 loss, kernel route vs plain: a mean of S token losses, each moved
# by the kernel's bf16 P (phase 5's logits differ by <= 0.1 of max |ref|)
TRAIN_LOSS_REL_TOL = 1e-2


def moe_arch(aid: str, rehearse: bool):
    """The MoE arch at full width and MOE_DEPTH layers on the card; on the
    CPU a width-64 copy with the published expert count and top-k."""
    arch = get_arch(aid)
    cfg = dataclasses.replace(arch.cfg, n_layers=MOE_DEPTH[aid])
    if rehearse:
        cfg = dataclasses.replace(cfg, d_model=64, n_heads=4, n_kv_heads=2,
                                  head_dim=16, d_ff=128, vocab=256)
    return dataclasses.replace(arch, cfg=cfg)


@contextlib.contextmanager
def record_routing():
    """Record, per MoE layer call made through ``tfm.moe_route`` while the
    block runs, its router input x, the router and its Routing."""
    fn = tfm.moe_route
    calls = []

    def recorded(cfg, router, x):
        r = fn(cfg, router, x)
        calls.append(dict(x=x.detach(), router=router, routing=r))
        return r
    tfm.moe_route = recorded
    try:
        yield calls
    finally:
        tfm.moe_route = fn


def routing_record(cfg, calls: list) -> list:
    """Per layer: tokens kept by each expert and dropped (token, choice)
    pairs; the routing integers recomputed on the CPU from the card's own
    gates must equal the card's (no float atomic or sort order decides
    them)."""
    out = []
    for i, c in enumerate(calls):
        r = c["routing"]
        gates = tfm.moe_gates(c["router"], c["x"])
        cpu = tfm.route_from_gates(cfg, gates.cpu())
        same = all(torch.equal(getattr(r, f).cpu(), getattr(cpu, f))
                   for f in ("top_e", "pos", "keep"))
        check(same, f"{cfg.name} layer {i}: card routing != CPU routing "
              f"of the same gates")
        top = gates.topk(2, dim=-1).values
        out.append(dict(
            capacity=r.capacity,
            tokens_per_expert=torch.bincount(
                r.top_e[r.keep], minlength=cfg.n_experts).tolist(),
            dropped=int((~r.keep).sum()),
            gate_ties=int((top[:, 0] == top[:, 1]).sum()),
            card_equals_cpu=same))
    return out


def compare_routes(cfg, kern: list, plain: list):
    """The two attention routes' routing, layer by layer: tokens whose
    router logits came out bitwise equal must get the same experts;
    positions and keeps must be equal up to the first token whose experts
    differ (a position counts every earlier choice of its expert). Counts
    what differs. Also returns the (S,) mask of the tokens that every
    layer gave the same experts and the same keep in both routes."""
    rows = []
    same_route = None
    for i, (a, b) in enumerate(zip(kern, plain)):
        ra, rb = a["routing"], b["routing"]
        la = a["x"] @ a["router"].to(a["x"].dtype)
        lb = b["x"] @ b["router"].to(b["x"].dtype)
        same_logits = (la == lb).all(-1)
        same_e = (ra.top_e == rb.top_e).all(-1)
        check(bool(same_e[same_logits].all()),
              f"{cfg.name} layer {i}: equal router logits, other experts")
        first = int(same_e.logical_not().nonzero()[0, 0]) \
            if not bool(same_e.all()) else same_e.numel()
        check(torch.equal(ra.pos[:first], rb.pos[:first])
              and torch.equal(ra.keep[:first], rb.keep[:first]),
              f"{cfg.name} layer {i}: positions differ before the first "
              f"differing choice")
        same = same_e & (ra.keep == rb.keep).all(-1)
        same_route = same if same_route is None else same_route & same
        rows.append(dict(tokens_equal_logits=int(same_logits.sum()),
                         tokens_other_experts=int((~same_e).sum()),
                         tokens_other_keep=int(
                             (ra.keep != rb.keep).any(-1).sum()),
                         first_differing_token=first,
                         all_equal=bool(same_e.all()) and torch.equal(
                             ra.pos, rb.pos) and torch.equal(ra.keep,
                                                             rb.keep)))
    return dict(layers=rows, all_equal=all(r["all_equal"] for r in rows),
                tokens_same_route=int(same_route.sum())), same_route


def logits_agree_where(got, ref, mask, what: str) -> dict:
    """``logits_agree`` over the positions of ``mask`` (S,), with the
    scale of every position's |ref|; greedy agreement over all positions
    (gated at GREEDY_AGREE_MIN) and over the masked ones."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite logits")
    err = (got - ref).abs_().amax(-1)[0]                     # (S,)
    scale = float(ref.abs().max())
    agree = (got.argmax(-1) == ref.argmax(-1))[0]
    out = dict(max_abs_err=float(err[mask].max()), max_abs_ref=scale,
               rel_err=float(err[mask].max()) / scale,
               greedy_agreement=float(agree[mask].float().mean()),
               positions=int(mask.sum()),
               other_positions=int((~mask).sum()),
               other_max_abs_err=float(err[~mask].max())
               if bool((~mask).any()) else None,
               greedy_agreement_all=float(agree.float().mean()))
    check(out["rel_err"] <= LOGITS_REL_TOL,
          f"{what}: max |diff| {out['max_abs_err']} > {LOGITS_REL_TOL} x "
          f"max |ref| {scale} at the positions routed alike ({out})")
    check(out["greedy_agreement_all"] >= GREEDY_AGREE_MIN,
          f"{what}: greedy agreement {out['greedy_agreement_all']} < "
          f"{GREEDY_AGREE_MIN} ({out})")
    check(out["positions"] >= GREEDY_AGREE_MIN * mask.numel(),
          f"{what}: only {out['positions']} of {mask.numel()} positions "
          f"routed alike in every layer")
    return out


def phase11_moe(aid: str, rehearse: bool, gen) -> dict:
    """One MoE arch: prefill (1, S) through the kernel (counted) and
    through plain attention, phase 5's gates on the logits, the routing
    of both; then decode steps at context P0 of an S-slot cache."""
    arch = moe_arch(aid, rehearse)
    cfg = arch.cfg
    S, P0, n_steps = MOE_RUN["rehearse" if rehearse else "card"]
    sync()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, gen, DEV)
    sync()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       [params[k] for k in params if k != "layers"]
                       + list(params["layers"].values()))
    log(f"  {cfg.name}: {cfg.n_layers} of {get_arch(aid).cfg.n_layers} "
        f"layers (depth cut to fit one card), d {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, "
        f"{weight_bytes / 1e9:.2f} GB of bf16 weights, drawn in "
        f"{init_s:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (1, S), device=DEV, generator=gen)
    prefill = arch.step_fn(arch.shapes["prefill_32k"])
    plain = arch.step_fn(arch.shapes["prefill_32k"], backend="reference")
    if DEV.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counters()
    sync()
    t0 = time.perf_counter()
    with record_routing() as kern_calls:
        logits = prefill(params, tokens)            # the path, counted
    sync()
    first_s = time.perf_counter() - t0
    launches = all_launches()
    shapes = dict(flash_ops.shapes)
    peak = torch.cuda.max_memory_allocated() if DEV.type == "cuda" else 0
    check(tuple(logits.shape) == (1, S, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name} prefill: bad logits")
    want = {(1, cfg.n_heads, cfg.n_kv_heads, S, cfg.hd, None): cfg.n_layers}
    if DEV.type == "cuda":
        check(launches == {"triangle_mp": 0, "cycle_intersect": 0,
                           "flash_attention": cfg.n_layers,
                           "contract_matmul": 0},
              f"{cfg.name} prefill launched {launches}, want "
              f"{cfg.n_layers} flash")
        check(shapes == want, f"{cfg.name} prefill gave the kernel "
              f"{shapes}, want {want}")
    sync()
    t0 = time.perf_counter()
    prefill(params, tokens)
    sync()
    prefill_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    with record_routing() as plain_calls:
        ref = plain(params, tokens)
    sync()
    plain_s = time.perf_counter() - t0
    routing = routing_record(cfg, kern_calls)
    routes, same_route = compare_routes(cfg, kern_calls, plain_calls)
    for i, r in enumerate(routing):
        log(f"  {cfg.name} layer {i} routing: capacity {r['capacity']}, "
            f"tokens per expert {r['tokens_per_expert']}, dropped "
            f"{r['dropped']}, exact top-2 gate ties {r['gate_ties']}, card "
            f"= CPU on the same gates; vs the plain route "
            f"{routes['layers'][i]}")
    # a token routed otherwise in some layer runs other experts: its
    # logits are another function, not the kernel's rounding of this one
    vs_plain = logits_agree_where(logits, ref, same_route,
                                  f"{cfg.name} prefill kernel vs plain")
    # decode where the step is the same function as the prefill's row:
    # a token every layer of the prefill kept (a decode step routes its
    # one token with room to spare), and that the decode step routes to
    # the prefill's experts in every layer (its hidden state is the
    # prefill's up to rounding, so a near-tie of gates can go the other
    # way); candidates from P0 on, then before it, each on a copy of the
    # filled cache
    kept = torch.stack([c["routing"].keep.all(-1) for c in kern_calls]
                       ).all(0)
    prefill_e = [c["routing"].top_e for c in kern_calls]
    want_rows = logits
    del ref, kern_calls, plain_calls
    step = arch.step_fn(arch.shapes["decode_32k"])
    filled = tfm.init_kv_cache(cfg, 1, S, DEV)
    fill_cache(cfg, params, tokens, filled, "cuda")  # routed as the prefill
    order = list(range(P0, S - n_steps - 1)) + list(range(P0 - 1, 0, -1))
    tried = []
    for at in (p for p in order if bool(kept[p])):
        cache = {k: c.clone() for k, c in filled.items()}
        with record_routing() as dec_calls:
            dec, cache = step(params, cache, tokens[:, at], at)
        same = all(torch.equal(d["routing"].top_e[0], e[at])
                   for d, e in zip(dec_calls, prefill_e))
        del dec_calls
        if same:
            break
        tried.append(at)
        check(len(tried) < 16, f"{cfg.name}: 16 decode positions routed "
              f"otherwise than the prefill: {tried}")
    want_row = want_rows[:, at].clone()
    del want_rows, logits, filled
    vs_prefill = logits_agree(dec, want_row, f"{cfg.name} decode at "
                              f"context {at} vs prefill")
    vs_prefill["argmax_equal"] = bool(torch.equal(dec.argmax(-1),
                                                  want_row.argmax(-1)))
    vs_prefill["positions_routed_otherwise"] = tried
    check(vs_prefill["argmax_equal"],
          f"{cfg.name}: first decoded token {int(dec.argmax())} != the "
          f"prefill's argmax {int(want_row.argmax())} at {at}")
    sync()
    t0 = time.perf_counter()
    for t in range(at + 1, at + 1 + n_steps):
        dec, cache = step(params, cache, tokens[:, t], t)
    sync()
    decode_s = time.perf_counter() - t0
    check(bool(torch.isfinite(dec).all()), f"{cfg.name} decode: non-finite")
    out = dict(config=cfg.name, n_layers=cfg.n_layers,
               published_layers=get_arch(aid).cfg.n_layers,
               d_model=cfg.d_model, n_experts=cfg.n_experts,
               top_k=cfg.top_k, params=cfg.params_count,
               weight_bytes=weight_bytes, init_s=init_s, prefill_tokens=S,
               prefill_first_s=first_s, prefill_s=prefill_s,
               prefill_tokens_per_s=S / prefill_s, plain_prefill_s=plain_s,
               launches=launches,
               kernel_shapes={str(k): n for k, n in shapes.items()},
               peak_bytes=peak, vs_plain=vs_plain, routing=routing,
               routes=routes, decode_context=at, vs_prefill=vs_prefill,
               decode_steps=n_steps, decode_s=decode_s,
               decode_steps_per_s=n_steps / decode_s)
    log(f"  {cfg.name} prefill (1, {S}): {prefill_s:.3f} s "
        f"({S / prefill_s:.0f} tokens/s; first call {first_s:.3f} s), "
        f"plain attention {plain_s:.3f} s; launches {launches}, shapes "
        f"{out['kernel_shapes']}; peak {peak / 2**30:.2f} GiB; kernel vs "
        f"plain {vs_plain} [{CARD_NAME}]")
    log(f"  {cfg.name} decode at context {at} of {S} slots: vs prefill "
        f"{vs_prefill}; {n_steps} more steps {out['decode_steps_per_s']:.2f}"
        f" steps/s (batch 1) [{CARD_NAME}]")
    return out


def attention_taps(n: int):
    """Record the first ``n`` calls of ``tfm.flash_attention_trainable``
    (a step's forward, before its backward recomputes them): q, k, v, the
    mask options, and by hooks the output's cotangent and q, k and v's
    gradients as the step's backward computes them."""
    fn = tfm.flash_attention_trainable
    taps = []

    def tapped(q, k, v, **kw):
        out = fn(q, k, v, **kw)
        if len(taps) < n:
            rec = dict(q=q.detach(), k=k.detach(), v=v.detach(),
                       kw={k_: w for k_, w in kw.items() if k_ != "backend"})
            for name, t in (("dO", out), ("dq", q), ("dk", k), ("dv", v)):
                t.register_hook(lambda g, name=name, rec=rec:
                                rec.__setitem__(name, g))
            taps.append(rec)
        return out
    return fn, tapped, taps


def phase11_train(rehearse: bool, gen) -> dict:
    """gemma2-9b at full width and one local/global pair: five registry
    train steps on ``lm_batch`` through the kernel route (flash launches
    counted each step: 2 L under remat), step 1's loss against the plain
    route's and each attention layer's q, k, v gradients against the
    plain route's on the same inputs (bit for bit); a checkpoint after
    step 3, restored, and steps 4-5 again: the same bits."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import (
        OptimizerConfig, OptState, init_opt_state,
    )
    from repro_torch.tree import tree_leaves
    depth, S, n_steps, save_at = TRAIN_RUN["rehearse" if rehearse
                                           else "card"]
    arch = lm_config(rehearse)
    cfg = dataclasses.replace(arch.cfg, n_layers=depth)
    arch = dataclasses.replace(arch, cfg=cfg, opt=dataclasses.replace(
        arch.opt, **TRAIN_OPT))
    shape = arch.shapes["train_4k"]
    step_fn = arch.step_fn(shape)
    sync()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, gen, DEV, masters=True)
    opt = init_opt_state(params, state_dtype=arch.opt_state_dtype)
    sync()
    init_s = time.perf_counter() - t0
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_leaves(params) + tree_leaves(opt))
    log(f"  {cfg.name}: {depth} of 42 layers (depth cut: 42 layers' f32 "
        f"masters, gradients and AdamW moments need ~162 GB), "
        f"{cfg.params_count} params, {state_bytes / 1e9:.2f} GB of masters "
        f"and moments, drawn in {init_s:.2f} s; lr {arch.opt.lr} "
        f"constant, batch (1, {S})")

    def batch(s):
        return lm_batch(s, 1, S + 1, cfg.vocab, seed=0, device=DEV)

    b0 = batch(0)
    with torch.no_grad():
        plain_loss = float(tfm.loss_fn(cfg, params, b0["tokens"],
                                       b0["targets"], backend="reference"))
    ckpt_dir = ROOT / "build" / "phase11_checkpoint"
    losses, walls, launches, pending = [], [], [], None
    if DEV.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for s in range(n_steps):
        b = batch(s)
        orig = tapped = None
        if s == 0:
            orig, tapped, taps = attention_taps(depth)
            tfm.flash_attention_trainable = tapped
        reset_counters()
        sync()
        t0 = time.perf_counter()
        try:
            params, opt, m = step_fn(params, opt, b["tokens"], b["targets"])
            sync()
        finally:
            if orig is not None:
                tfm.flash_attention_trainable = orig
        walls.append(time.perf_counter() - t0)
        launches.append(all_launches())
        losses.append(float(m["loss"]))
        if s + 1 == save_at:
            pending = ckpt.save_checkpoint_async(
                str(ckpt_dir), save_at, {"params": params, "opt": opt},
                keep=1)
            saved_s = time.perf_counter() - t0 - walls[-1]
    peak = torch.cuda.max_memory_allocated() if DEV.type == "cuda" else 0
    t0 = time.perf_counter()
    pending.join()
    join_s = time.perf_counter() - t0
    want_flash = 2 * depth if DEV.type == "cuda" else 0
    for s, n in enumerate(launches):
        check(n == {"triangle_mp": 0, "cycle_intersect": 0,
                    "flash_attention": want_flash, "contract_matmul": 0},
              f"train step {s + 1} launched {n}, want {want_flash} flash "
              f"(2 L: forward and the remat recompute)")
    check(all(np.isfinite(losses)), f"train losses {losses}")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    check(rel <= TRAIN_LOSS_REL_TOL,
          f"step-1 loss kernel route {losses[0]} vs plain {plain_loss}")
    # each attention layer of step 1: the plain route's gradients on the
    # same q, k, v and cotangent equal the kernel route's, bit for bit
    check(len(taps) == depth and all("dq" in t for t in taps),
          f"step 1 tapped {len(taps)} attention layers")
    grads_equal = []
    for i, t in enumerate(taps):
        leaves = [t[n].clone().requires_grad_() for n in ("q", "k", "v")]
        out = flash_ops.flash_attention_trainable(
            *leaves, backend="reference", **t["kw"])
        ref = torch.autograd.grad(out, leaves, t["dO"])
        same = [torch.equal(a, t[n]) for a, n in zip(ref, ("dq", "dk",
                                                           "dv"))]
        check(all(same), f"train step 1 layer {i}: kernel-route q/k/v "
              f"gradients != plain route's {same}")
        grads_equal.append(dict(layer=i, window=t["kw"]["window"],
                                dq_dk_dv_bitwise_equal=same))
    del taps
    # the loss falls: batch 0's loss after the five steps against step 1's
    with torch.no_grad():
        after = float(tfm.loss_fn(cfg, params, b0["tokens"], b0["targets"]))
    check(after < losses[0], f"batch 0's loss {losses[0]} -> {after} after "
          f"{n_steps} steps: did not fall")
    # resume: restore step 3's checkpoint and run steps 4-5 again
    final = params
    step_count = int(opt.step)
    del opt
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tmpl = {"params": final, "opt": OptState(
        step=torch.zeros((), dtype=torch.int32, device=DEV), mu=final,
        nu=final)}
    loaded, info = ckpt.load_checkpoint(str(ckpt_dir), tmpl)
    state = ckpt.restore(loaded, tmpl)
    del loaded
    sync()
    load_s = time.perf_counter() - t0
    params, opt = state["params"], state["opt"]
    del state
    check(info["step"] == save_at and int(opt.step) == save_at,
          f"restored step {info['step']}")
    resumed = []
    for s in range(save_at, n_steps):
        b = batch(s)
        params, opt, m = step_fn(params, opt, b["tokens"], b["targets"])
        resumed.append(float(m["loss"]))
    same_params = all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(params), tree_leaves(final)))
    check(resumed == losses[save_at:] and same_params
          and int(opt.step) == step_count,
          f"resume from step {save_at}: losses {resumed} vs "
          f"{losses[save_at:]}, params equal {same_params}")
    ckpt_bytes = sum(f.stat().st_size for f in ckpt_dir.iterdir())
    for f in ckpt_dir.iterdir():
        f.unlink()
    ckpt_dir.rmdir()
    del params, opt, final
    out = dict(config=cfg.name, n_layers=depth, params=cfg.params_count,
               state_bytes=state_bytes, init_s=init_s, tokens=S,
               opt=dataclasses.asdict(arch.opt), losses=losses,
               loss_step5_below_step1=losses[-1] < losses[0],
               batch0_loss_after=after, plain_step1_loss=plain_loss,
               step1_loss_rel_diff=rel, step_s=walls,
               step_s_median=statistics.median(walls),
               tokens_per_s=S / statistics.median(walls),
               launches_per_step=[n["flash_attention"] for n in launches],
               peak_bytes=peak, grads_equal=grads_equal,
               checkpoint_bytes=ckpt_bytes, save_copy_s=saved_s,
               save_join_s=join_s, load_s=load_s, resumed_losses=resumed,
               resume_bit_exact=same_params)
    log(f"  train steps: losses {losses} (batch 0: {losses[0]:.4f} -> "
        f"{after:.4f} after {n_steps} steps); step 1 plain-route loss "
        f"{plain_loss:.6f} (rel diff {rel:.2e}); flash launches a step "
        f"{out['launches_per_step']}; q/k/v gradients bitwise equal to the "
        f"plain route's in {depth} layers [{CARD_NAME}]")
    log(f"  train step wall {[round(w, 3) for w in walls]} s (median "
        f"{out['step_s_median']:.3f} s, {out['tokens_per_s']:.0f} "
        f"tokens/s), peak {peak / 2**30:.2f} GiB; checkpoint "
        f"{ckpt_bytes / 1e9:.2f} GB: host copy {saved_s:.2f} s, write "
        f"finished {join_s:.2f} s after step {n_steps}, load {load_s:.2f} "
        f"s; steps {save_at + 1}-{n_steps} from it: losses {resumed}, "
        f"params bit-equal {same_params} [{CARD_NAME}]")
    return out


def phase11_entry_points(rehearse: bool) -> dict:
    """``launch/train.py`` and ``launch/serve.py`` on the card from their
    flags, at their own reduction (no flash kernel): smokes, not
    measures."""
    from repro_torch.launch import train as train_launch
    hist = train_launch.main(["--arch", "gemma2-9b", "--reduce", "16",
                              "--steps", "3", "--batch", "2", "--seq", "64",
                              "--device", str(DEV)])
    check(len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist),
          f"launch/train.py: {hist}")
    served = {}
    for aid in MOE_DEPTH:
        r = serve.main(["--arch", aid, "--reduce", "16", "--batch", "2",
                        "--prompt-len", "4", "--gen", "3", "--requests",
                        "3", "--device", str(DEV)])
        check(r["served"] == 3, f"launch/serve.py {aid}: {r['served']}")
        served[aid] = dict(steps=r["steps"], seconds=r["seconds"])
    return dict(train_losses=[h["loss"] for h in hist], serve=served)


def phase_moe_train(rehearse: bool) -> dict:
    """Phase 11: (a) the two MoE archs served, one after the other, (b)
    the LM train step, (c) the training and serving entry points; then
    the flash kernel held against its plain version at the MoE prefill's
    shapes (the train step's are phase 2's gemma2 cases). Its own
    generator, so the phase draws the same weights alone or after the
    others."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    t0 = time.perf_counter()
    out = {"moe": {}}
    for aid in MOE_DEPTH:
        out["moe"][aid] = phase11_moe(aid, rehearse, gen)
        if DEV.type == "cuda":
            torch.cuda.empty_cache()
    out["train"] = phase11_train(rehearse, gen)
    if DEV.type == "cuda":
        torch.cuda.empty_cache()
    out["entry_points"] = phase11_entry_points(rehearse)
    S = MOE_RUN["rehearse" if rehearse else "card"][0]
    out["flash_cases"] = []
    for aid in MOE_DEPTH:
        c = moe_arch(aid, rehearse).cfg
        out["flash_cases"].append(flash_case(
            f"{aid} prefill", 1, c.n_heads, c.n_kv_heads, S, c.hd, None,
            None, gen))
        log_case("flash_attention", out["flash_cases"][-1])
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 11 took {out['phase_s']:.1f} s [{CARD_NAME}]")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the sparse substrate's families (GNN, wide-deep) at full width
# ---------------------------------------------------------------------------

# (a) wide-deep: (rows a field, serve batches, retrieval candidates, train
# batch, rows of the serve batch held against the CPU, timed calls of the
# small and the large serve batch)
RECSYS_RUN = {"card": (1_000_000, (512, 262_144), 1_000_000, 65_536, 4096,
                       (20, 5)),
              "rehearse": (1000, (16, 64), 1000, 64, 16, (2, 2))}
# card vs CPU: serve logits (float32 matmuls, TF32 off; the card's MLP
# sums in another order) and retrieval scores (a 64-long dot each)
RECSYS_CPU_REL_TOL = 1e-4
RETRIEVAL_CPU_TOL = dict(rtol=1e-5, atol=1e-5)
RECSYS_TRAIN_STEPS = 3          # on one batch: the loss must fall
# (b) the registry's GNN train steps at full width: (arch, shape)
GNN_CELLS = [("dimenet", "molecule"), ("egnn", "molecule"),
             ("mace", "molecule"), ("graphcast", "full_graph_sm"),
             ("graphcast", "minibatch_lg")]
GNN_CPU_SHAPES = ("molecule", "full_graph_sm")   # step 1 held vs the CPU
GNN_CPU_REL_TOL = 1e-3          # step-1 loss and gradient norm
GNN_STEPS = 4                   # one batch: a warm-up, then 3 timed
# the GNN steps' optimizer: the registry's AdamW unwarmed at lr 1e-4 (at
# 3e-4, Adam's first sign-sized steps overshoot on graphcast's 16 x 512
# processor: full_graph_sm's loss read 1.966, 2.198, 1.995, 2.000 over
# four steps on the H100)
GNN_OPT = dict(lr=1e-4, warmup_steps=0, schedule="constant")
GNN_REHEARSE = {
    "dims": {"molecule": dict(n_nodes=8, n_edges=16, batch=4, d_feat=16,
                              task="energy"),
             "full_graph_sm": dict(n_nodes=32, n_edges=64, d_feat=12,
                                   n_classes=7, task="node_cls"),
             "minibatch_lg": dict(n_nodes=64, n_edges=96, d_feat=10,
                                  n_classes=41, task="node_cls",
                                  n_seeds=16)},
    "cut": {"dimenet": dict(n_blocks=2, d_hidden=16),
            "egnn": dict(n_layers=2, d_hidden=16),
            "mace": dict(n_layers=2, d_hidden=16),
            "graphcast": dict(n_layers=2, d_hidden=32)}}
WEATHER_STEPS = 3               # (c): a warm-up train step, then 2 timed
NO_KERNELS = {"triangle_mp": 0, "cycle_intersect": 0, "flash_attention": 0,
              "contract_matmul": 0}


def tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def peak_reset():
    if DEV.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes() -> int:
    return torch.cuda.max_memory_allocated() if DEV.type == "cuda" else 0


def empty_cache():
    if DEV.type == "cuda":
        torch.cuda.empty_cache()


def timed_call(fn, reps: int) -> tuple[float, list]:
    """(median seconds, every wall) of ``reps`` calls of ``fn``, each
    ended by a synchronise, after one warm-up call."""
    fn()
    walls = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def check_no_kernels(what: str):
    n = all_launches()
    check(n == NO_KERNELS, f"{what} launched {n}: no kernel of the port is "
          f"on this path")


def phase12_recsys(rehearse: bool, gen) -> dict:
    """(a) wide-deep at full width: serve at batch 512 and 262 144,
    retrieval over 1 000 448 padded candidates, the train step at 65 536
    (three on one batch); the serve logits of the first rows and the
    retrieval held against the CPU."""
    from repro_torch.data import synthetic
    from repro_torch.models import recsys as rs
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.tree import tree_map
    V, serve_b, n_cand, train_b, n_par, (reps_s, reps_b) = RECSYS_RUN[
        "rehearse" if rehearse else "card"]
    arch = get_arch("wide-deep")
    arch = dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, vocab_per_field=V),
        opt=dataclasses.replace(arch.opt, **TRAIN_OPT))
    cfg, shapes = arch.cfg, arch.shapes
    reset_counters()
    sync()
    t0 = time.perf_counter()
    params = rs.init_params(cfg, gen)
    sync()
    init_s = time.perf_counter() - t0
    out = dict(config=dataclasses.asdict(cfg), init_s=init_s,
               param_bytes=tree_bytes(params),
               table_bytes=tree_bytes([params["tables"],
                                       params["wide_tables"]]))

    def batch(step, B):
        return synthetic.recsys_batch(step, B, cfg.n_sparse, V, cfg.n_dense,
                                      bag=cfg.multi_hot, device=DEV)

    serve = arch.step_fn(shapes["serve_p99"])
    for name, B, reps in (("serve_p99", serve_b[0], reps_s),
                          ("serve_bulk", serve_b[1], reps_b)):
        b = batch(1, B)
        peak_reset()
        with torch.no_grad():
            med, walls = timed_call(
                lambda: serve(params, b["sparse_idx"], b["dense_feats"]),
                reps)
            logits = serve(params, b["sparse_idx"], b["dense_feats"])
        check(logits.shape == (B,) and bool(torch.isfinite(logits).all()),
              f"{name}: logits {tuple(logits.shape)} not finite")
        flops = arch.model_flops(dataclasses.replace(shapes[name],
                                                     dims=dict(batch=B)))
        out[name] = dict(batch=B, median_s=med, walls=walls,
                         examples_per_s=B / med, peak_bytes=peak_bytes(),
                         model_tflop_per_s=flops / med / 1e12)
        log(f"  wide-deep {name} (batch {B}): median {1e3 * med:.3f} ms, "
            f"{B / med:.0f} examples/s, peak "
            f"{out[name]['peak_bytes'] / 2**30:.2f} GiB [{CARD_NAME}]")
    # the first rows of the bulk batch against the port's CPU forward on
    # the same tables (every param copied to the host)
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda t: t.cpu(), params)
    copy_s = time.perf_counter() - t0
    with torch.no_grad():
        want = rs.forward(cfg, cpu_params, b["sparse_idx"][:n_par].cpu(),
                          b["dense_feats"][:n_par].cpu())
    got = logits[:n_par].cpu()
    diff = float((got - want).abs().max())
    rel = diff / max(float(want.abs().max()), 1e-30)
    check(rel <= RECSYS_CPU_REL_TOL, f"serve logits card vs CPU: max |diff| "
          f"{diff} = {rel:.2e} of max |CPU|")
    out["cpu_parity"] = dict(rows=n_par, max_abs_diff=diff, rel_diff=rel,
                             bitwise_equal=bool(torch.equal(got, want)),
                             host_copy_s=copy_s)
    del cpu_params, logits
    # retrieval: candidates padded to a 512-multiple; the padding rows are
    # 0 (score 0) and must not reach the top 128 of random candidates
    rshape = dataclasses.replace(shapes["retrieval_cand"], dims=dict(
        batch=1, n_candidates=n_cand))
    specs = arch.input_specs(rshape)
    nc = specs["cands"].shape[0]
    q = torch.randn(specs["query"].shape, generator=gen, device=DEV)
    cands = torch.randn((nc, cfg.cand_dim), generator=gen, device=DEV)
    cands[n_cand:] = 0
    retrieve = arch.step_fn(rshape)
    med, walls = timed_call(lambda: retrieve(q, cands), reps_s)
    vals, idx = retrieve(q, cands)
    check(int(idx.max()) < n_cand, f"retrieval picked a padding row "
          f"{int(idx.max())} >= {n_cand}")
    cv, ci = torch.topk(rs.retrieval_score(q.cpu(), cands.cpu()),
                        vals.shape[0])
    gv = vals.cpu()
    vdiff = float((gv - cv).abs().max())
    check(torch.allclose(gv, cv, **RETRIEVAL_CPU_TOL),
          f"retrieval values card vs CPU: max |diff| {vdiff}")
    distinct = torch.ones_like(cv, dtype=torch.bool)
    distinct[1:] &= cv[1:] != cv[:-1]
    distinct[:-1] &= cv[:-1] != cv[1:]
    idx_equal = bool(torch.equal(idx.cpu().long()[distinct], ci[distinct]))
    check(idx_equal, "retrieval indices card vs CPU differ where the values "
          "are distinct")
    out["retrieval"] = dict(
        n_candidates=n_cand, padded=nc, top_k=int(vals.shape[0]),
        median_s=med, walls=walls, candidates_per_s=n_cand / med,
        candidate_bytes=nc * cfg.cand_dim * 4,
        max_abs_diff_vs_cpu=vdiff,
        values_bitwise_equal_cpu=bool(torch.equal(gv, cv)),
        indices_equal_where_distinct=idx_equal)
    log(f"  wide-deep retrieval_cand ({n_cand} candidates padded to {nc}, "
        f"top {vals.shape[0]}): median {1e3 * med:.3f} ms, "
        f"{nc * cfg.cand_dim * 4 / med / 1e9:.1f} GB/s of candidates; "
        f"values vs CPU max |diff| {vdiff:.2e} (bitwise "
        f"{out['retrieval']['values_bitwise_equal_cpu']}) [{CARD_NAME}]")
    del cands
    # train: three registry steps on one batch of train_batch's size
    step = arch.step_fn(shapes["train_batch"])
    b = batch(2, train_b)
    opt = init_opt_state(params)
    out["state_bytes"] = tree_bytes(params) + tree_bytes(opt)
    peak_reset()
    losses, walls = [], []
    for _ in range(RECSYS_TRAIN_STEPS):
        sync()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b["sparse_idx"],
                              b["dense_feats"], b["labels"])
        sync()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    peak = peak_bytes()
    with torch.no_grad():
        after = float(rs.loss_fn(cfg, params, b["sparse_idx"],
                                 b["dense_feats"], b["labels"]))
    check(all(np.isfinite(losses)) and after < losses[0],
          f"wide-deep train: losses {losses}, then {after}: did not fall")
    med = statistics.median(walls)
    flops = arch.model_flops(dataclasses.replace(shapes["train_batch"],
                                                 dims=dict(batch=train_b)))
    out["train"] = dict(batch=train_b, losses=losses, loss_after=after,
                        step_s=walls, step_s_median=med,
                        examples_per_s=train_b / med,
                        model_tflop_per_s=flops / med / 1e12,
                        peak_bytes=peak, opt=dataclasses.asdict(arch.opt))
    check_no_kernels("wide-deep")
    log(f"  wide-deep train_batch ({train_b}): step walls "
        f"{[round(w, 4) for w in walls]} s, losses {losses} -> {after:.6f}, "
        f"peak {peak / 2**30:.2f} GiB with {out['state_bytes'] / 1e9:.2f} GB "
        f"of params and AdamW moments [{CARD_NAME}]")
    del params, opt
    return out


def gnn_cell(aid: str, shape_name: str, rehearse: bool):
    """The registry's arch and shape with GNN_OPT; on the CPU cut to 2
    layers at small dims."""
    arch = get_arch(aid)
    shape = arch.shapes[shape_name]
    if rehearse:
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, **GNN_REHEARSE["cut"][aid]))
        shape = dataclasses.replace(shape,
                                    dims=GNN_REHEARSE["dims"][shape_name])
    return dataclasses.replace(arch, opt=dataclasses.replace(
        arch.opt, **GNN_OPT)), shape


def gnn_batch(arch, shape) -> dict:
    """The step's inputs at the arch's padded shape, from the port's
    synthetic batches (seed 0, step 0); padded nodes and edges masked, a
    ``minibatch_lg`` batch's labels on its first ``n_seeds`` nodes."""
    from repro_torch.data import synthetic
    from repro_torch.models.gnn.common import build_triplets
    d = arch._dims(shape)
    N, E = d["N"], d["E"]
    if d["task"] == "energy":
        g = synthetic.molecule_train_batch(0, d["batch"], d["n_nodes"],
                                           d["n_edges"], d["d_feat"],
                                           device=DEV)
    else:
        g = synthetic.node_classification_batch(
            0, d["n_nodes"], d["n_edges"], d["d_feat"], d["n_classes"],
            device=DEV)

    def pad(t, size, fill=0):
        out = torch.full((size,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                         device=DEV)
        out[:t.shape[0]] = t
        return out

    b = dict(nodes=pad(g.nodes, N), edges_src=pad(g.edges_src, E),
             edges_dst=pad(g.edges_dst, E),
             node_mask=pad(g.node_mask, N, False),
             edge_mask=pad(g.edge_mask, E, False),
             graph_ids=pad(g.graph_ids, N))
    if d["task"] == "energy":
        b["labels_f"] = g.labels
        b["positions"] = pad(g.positions, N)
    else:
        b["labels_i"] = pad(g.labels, N)
        b["label_mask"] = pad(g.node_mask, N, False)
        if "n_seeds" in d:
            b["label_mask"][d["n_seeds"]:] = False
    specs = arch.input_specs(shape)
    if "tri_kj" in specs:
        tri = build_triplets(g.edges_src.cpu().numpy(),
                             g.edges_dst.cpu().numpy(),
                             specs["tri_kj"].shape[0])
        for k, a in zip(("tri_kj", "tri_ji", "tri_mask"), tri):
            b[k] = torch.from_numpy(a).to(DEV)
    for k, s in specs.items():
        check(tuple(b[k].shape) == s.shape and b[k].dtype == s.dtype,
              f"gnn batch {k}: {tuple(b[k].shape)} {b[k].dtype} vs {s}")
    return {k: b[k] for k in specs}


def phase12_gnn_cell(aid: str, shape_name: str, rehearse: bool, gen) -> dict:
    """One registry train step cell: GNN_STEPS steps on one batch (the
    first a warm-up, then timed), the loss falling, peak memory; on
    GNN_CPU_SHAPES step 1's loss and gradient norm against the port on
    the CPU with the same params and batch."""
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.tree import tree_leaves, tree_map
    arch, shape = gnn_cell(aid, shape_name, rehearse)
    d = arch._dims(shape)
    t0 = time.perf_counter()
    batch = gnn_batch(arch, shape)
    sync()
    batch_s = time.perf_counter() - t0
    params = arch.init_params(shape, gen)
    opt = init_opt_state(params)
    step = arch.step_fn(shape)
    cpu = None
    if shape_name in GNN_CPU_SHAPES:
        cp = tree_map(lambda t: t.cpu(), params)
        cb = {k: v.cpu() for k, v in batch.items()}
        t0 = time.perf_counter()
        loss, grads = value_and_grad(arch._loss(shape), cp, cb)
        gnorm = torch.sqrt(sum(g.square().sum() for g in tree_leaves(grads)))
        cpu = dict(loss=float(loss), grad_norm=float(gnorm),
                   seconds=time.perf_counter() - t0)
        del cp, cb, grads
    reset_counters()
    peak_reset()
    losses, gnorms, walls = [], [], []
    for _ in range(GNN_STEPS):
        sync()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, **batch)
        sync()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = peak_bytes()
    check_no_kernels(f"{aid} on {shape_name}")
    check(all(np.isfinite(losses + gnorms)), f"{aid} {shape_name}: losses "
          f"{losses}, gradient norms {gnorms}")
    check(losses[-1] < losses[0], f"{aid} {shape_name}: losses {losses} did "
          f"not fall over {GNN_STEPS - 1} steps on one batch")
    if cpu is not None:
        for k, got in (("loss", losses[0]), ("grad_norm", gnorms[0])):
            rel = abs(got - cpu[k]) / max(abs(cpu[k]), 1e-30)
            cpu[f"{k}_rel_diff"] = rel
            check(rel <= GNN_CPU_REL_TOL, f"{aid} {shape_name} step 1 {k}: "
                  f"card {got} vs CPU {cpu[k]}")
    med = statistics.median(walls[1:])
    flops = arch.model_flops(shape)
    out = dict(arch=aid, shape=shape_name,
               dims=dict(N=d["N"], E=d["E"], d_feat=d["d_feat"],
                         T=arch.tri_factor * d["E"] if aid == "dimenet"
                         else None),
               config=dataclasses.asdict(arch.cfg),
               params=sum(t.numel() for t in tree_leaves(params)),
               batch_s=batch_s, losses=losses, grad_norms=gnorms,
               step_s=walls, step_s_median=med, peak_bytes=peak,
               model_flops=flops, model_tflop_per_s=flops / med / 1e12,
               cpu=cpu)
    log(f"  {aid} on {shape_name} (N {d['N']}, E {d['E']}): step median "
        f"{1e3 * med:.1f} ms of {[round(1e3 * w, 1) for w in walls]}, "
        f"{flops / med / 1e12:.2f} model TFLOP/s, peak "
        f"{peak / 2**30:.2f} GiB; losses {[round(x, 5) for x in losses]}"
        + ("" if cpu is None else
           f"; step 1 vs CPU: loss {cpu['loss_rel_diff']:.1e}, gradient "
           f"norm {cpu['grad_norm_rel_diff']:.1e}") + f" [{CARD_NAME}]")
    del params, opt, batch
    return out


def phase12_weather(rehearse: bool, gen) -> dict:
    """(c) GraphCast's native weather path at its config: the topology on
    the host, forwards and train steps (walls, peaks), a 2-step rollout."""
    from repro_torch.data import synthetic
    from repro_torch.examples import weather_graphcast
    from repro_torch.models.gnn import graphcast as gc
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import (
        OptimizerConfig, apply_update, init_opt_state,
    )
    cfg = weather_graphcast.CFG if rehearse else get_arch("graphcast").cfg
    t0 = time.perf_counter()
    topo = gc.build_topology(cfg, seed=0, device=DEV)
    sync()
    topo_s = time.perf_counter() - t0
    sizes = dict(n_grid=cfg.n_grid, n_mesh=cfg.n_mesh,
                 mesh_edges=len(topo.mesh_src), g2m_edges=len(topo.g2m_src),
                 m2g_edges=len(topo.m2g_src))
    check((sizes["mesh_edges"], sizes["g2m_edges"], sizes["m2g_edges"])
          == (cfg.n_mesh_edges, cfg.n_g2m_edges, cfg.n_m2g_edges),
          f"graphcast topology sizes {sizes}")
    params = gc.init_params(cfg, gen)
    b = synthetic.grid_weather_batch(0, cfg.n_grid, cfg.n_vars, device=DEV)
    x, y = b["grid_feats"], b["target"]
    reset_counters()
    peak_reset()
    with torch.no_grad():
        fwd_med, fwd_walls = timed_call(
            lambda: gc.forward(cfg, params, x, topo), 3)
    fwd_peak = peak_bytes()
    ocfg = OptimizerConfig(**GNN_OPT)
    opt = init_opt_state(params)
    peak_reset()
    losses, walls = [], []
    for _ in range(WEATHER_STEPS):
        sync()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(
            lambda p: gc.loss_fn(cfg, p, x, y, topo), params)
        params, opt, _ = apply_update(ocfg, params, grads, opt)
        sync()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
        del grads
    train_peak = peak_bytes()
    with torch.no_grad():
        s1 = gc.forward(cfg, params, x, topo)
        s2 = gc.forward(cfg, params, s1, topo)
    finite = bool(torch.isfinite(s1).all() and torch.isfinite(s2).all())
    check(finite and all(np.isfinite(losses)),
          f"graphcast weather: losses {losses}, rollout finite {finite}")
    check_no_kernels("graphcast weather")
    out = dict(config=dataclasses.asdict(cfg), sizes=sizes,
               topology_s=topo_s, forward_s_median=fwd_med,
               forward_s=fwd_walls, forward_peak_bytes=fwd_peak,
               train_step_s=walls,
               train_step_s_median=statistics.median(walls[1:]),
               train_peak_bytes=train_peak, losses=losses,
               rollout_mean_abs=[float(s1.abs().mean()),
                                 float(s2.abs().mean())])
    log(f"  graphcast weather ({cfg.grid_lat}x{cfg.grid_lon} grid, "
        f"refinement {cfg.mesh_refinement}: {cfg.n_mesh} mesh nodes, "
        f"{sizes['mesh_edges']} mesh edges; {cfg.n_layers} x "
        f"{cfg.d_hidden}, {cfg.n_vars} vars): topology {topo_s:.2f} s on "
        f"the host; forward median {fwd_med:.3f} s, peak "
        f"{fwd_peak / 2**30:.2f} GiB; train steps "
        f"{[round(w, 3) for w in walls]} s, peak "
        f"{train_peak / 2**30:.2f} GiB; losses {losses}; 2-step rollout "
        f"finite [{CARD_NAME}]")
    del params, opt, topo
    return out


def phase12_gnn_multicut(gen) -> dict:
    """(d) ``repro_torch.examples.gnn_multicut`` on the card at its own
    config (its assert is the RAMA-agreement gate), counters zeroed just
    before and read just after; the card's solve equals the plain
    backend's on the card bit for bit, and the CPU port's solve of the
    same cost array in labels and every integer field, objective and
    bound within CPU_REL_TOL (phase 4's and 6's gate: the dense path's
    bound sums in the device's order); triangle_mp held against its
    plain version at the MP shapes this solve gave it."""
    from repro_torch.examples import gnn_multicut as gm
    reset_counters()
    t0 = time.perf_counter()
    try:
        ex = gm.main(["--device", str(DEV)])
    except AssertionError as e:
        raise SmokeFailure(f"gnn_multicut: {e}") from e
    example_s = time.perf_counter() - t0
    launches, shapes = all_launches(), path_shapes()
    res = host(ex["result"])
    inst = gm.instance(ex["src"], ex["dst"], ex["logit"], DEV)
    ref = host(api.solve(inst, mode="pd", config=gm.SOLVER,
                         backend="reference", device=DEV))
    diff = same_result(res, ref)
    check(not diff, f"gnn_multicut: kernel backend != reference in {diff}")
    cpu = host(api.solve(gm.instance(ex["src"], ex["dst"], ex["logit"],
                                     "cpu"), mode="pd", config=gm.SOLVER,
                         device="cpu"))
    ints = [f for f in INTS if not np.array_equal(res[f], cpu[f])]
    check(not ints, f"gnn_multicut: card != CPU in {ints}")
    for f in ("objective", "lower_bound"):
        check(rel_close(res[f], cpu[f], CPU_REL_TOL),
              f"gnn_multicut: card {f} {res[f]} vs CPU {cpu[f]}")
    if DEV.type == "cuda":
        check(launches["triangle_mp"] == phase_launches(
                  shapes["triangle_mp"], gm.SOLVER.mp_iters) > 0,
              f"gnn_multicut solve launched {launches}, MP phases "
              f"{shapes['triangle_mp']}")
    cases = shape_cases(shapes, {"triangle_mp": set(),
                                 "cycle_intersect": set()},
                        int(inst.u.shape[0]), gen, "gnn_multicut",
                        timed=False)
    out = dict(steps=len(ex["losses"]),
               losses=[ex["losses"][0], ex["losses"][-1]],
               acc_rama=ex["acc_rama"], acc_thr=ex["acc_thr"],
               objective=float(res["objective"]),
               lower_bound=float(res["lower_bound"]),
               cpu_objective=float(cpu["objective"]),
               cpu_lower_bound=float(cpu["lower_bound"]),
               objective_bitwise_cpu=bool(res["objective"]
                                          == cpu["objective"]),
               bound_bitwise_cpu=bool(res["lower_bound"]
                                      == cpu["lower_bound"]),
               launches=launches, shapes=shape_record(shapes), cases=cases,
               example_s=example_s)
    log(f"  gnn_multicut: {out['steps']} EGNN steps, edge-BCE "
        f"{out['losses'][0]:.4f} -> {out['losses'][1]:.4f}; agreement RAMA "
        f"{ex['acc_rama']:.3f} vs threshold+CC {ex['acc_thr']:.3f}; solve "
        f"launches {launches}; kernel = plain bit for bit; card vs CPU: "
        f"labels equal, objective {out['objective']} / "
        f"{out['cpu_objective']}, bound {out['lower_bound']} / "
        f"{out['cpu_lower_bound']}; {example_s:.1f} s [{CARD_NAME}]")
    return out


def phase_gnn_recsys(rehearse: bool) -> dict:
    """Phase 12: (a) wide-deep, (b) the registry's GNN train steps, (c)
    GraphCast's native weather path, (d) the gnn_multicut example. Float32
    matmuls with TF32 off (torch's default), as the CPU parity gates
    assume. Its own generator, so the phase draws the same weights alone
    or after the others."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 12 runs float32 matmuls with TF32 off")
    gen = torch.Generator(device=DEV).manual_seed(12)
    t0 = time.perf_counter()
    out = {"recsys": phase12_recsys(rehearse, gen)}
    empty_cache()
    out["gnn"] = {}
    for aid, shape_name in GNN_CELLS:
        out["gnn"][f"{aid}/{shape_name}"] = phase12_gnn_cell(
            aid, shape_name, rehearse, gen)
        empty_cache()
    out["weather"] = phase12_weather(rehearse, gen)
    empty_cache()
    out["gnn_multicut"] = phase12_gnn_multicut(gen)
    # no kernel of the port lies on (a)-(c) (each checked zero launches);
    # (d)'s solve runs the multicut kernels
    out["kernel_launches"] = dict(recsys=NO_KERNELS, gnn=NO_KERNELS,
                                  weather=NO_KERNELS,
                                  gnn_multicut=out["gnn_multicut"][
                                      "launches"])
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 12 took {out['phase_s']:.1f} s [{CARD_NAME}]")
    return out


# ---------------------------------------------------------------------------
# Phase 13: the owner-partitioned DimeNet block over torch.distributed and
# the four multicut examples
# ---------------------------------------------------------------------------

# (a) (edges E, width d): DimeNet's width (configs/dimenet.py) at
# minibatch_lg's edge count (configs/base.py), T = 2E triplets (tri_factor
# 2), 90 % valid
P13 = {"card": (212_992, 128), "rehearse": (2048, 16)}
P13_SHARDS = 2
P13_DROP = 16           # the drop plan's halo: E / (D * 16) slots a peer
# max |Δ| / max |ref| of the block's output: float32 (TF32 off), the
# index_add's atomics and the matmuls sum in other orders than the dense
# reference's and the CPU's
P13_REL_TOL = 1e-5
P13_EXAMPLES = ("quickstart", "image_segmentation", "serve_tiles",
                "distributed_multicut")
# examples whose solves take the sparse path (above 256 padded nodes):
# cycle_intersect must launch there; the others' solves are dense
P13_SPARSE = ("image_segmentation", "distributed_multicut")

# one rank of (a): D = 2 over gloo on the parent's card; each plan's
# first call is counted (the warm-up), then three are timed
P13_RANK = """
import os, time
import numpy as np, torch
import torch.distributed as dist
from repro_torch.core import dist as td
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.ranks import process_group
from repro_torch.models.gnn import partitioned as tp
DEV, DIR = torch.device(%(dev)r), %(dir)r
def sync():
    if DEV.type == "cuda":
        torch.cuda.synchronize()
data = np.load(os.path.join(DIR, "inputs.npz"))
out = {}
with process_group("gloo") as (rank, world):
    w = {k: torch.from_numpy(data[k]).to(DEV) for k in ("w_tri", "w_upd")}
    mesh = make_debug_mesh(1, world, device_type=DEV.type)
    block = tp.make_triplet_block(mesh)
    for name in ("full", "drop"):
        p = np.load(os.path.join(DIR, name + ".npz"))
        plan = tp.PartitionedTriplets(
            *(torch.from_numpy(p[f]).to(DEV)
              for f in tp.PartitionedTriplets._fields[:5]),
            e_local=int(p["e_local"]), halo=int(p["halo"]))
        el = plan.e_local
        m = torch.from_numpy(data["m"][rank * el:(rank + 1) * el]).to(DEV)
        sync()
        if DEV.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        with td.count_collective_bytes() as rec:
            got = block(m, plan, w)
        sync()
        walls = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            block(m, plan, w)
            sync()
            walls.append(time.perf_counter() - t0)
        out[name + "/out"] = got.cpu().numpy()
        out[name + "/bytes"] = np.array([rec["bytes"], rec["calls"]])
        out[name + "/ms"] = np.array(walls) * 1e3
        out[name + "/peak"] = np.array(torch.cuda.max_memory_allocated()
                                       if DEV.type == "cuda" else 0)
    del block, mesh
out["group_destroyed"] = np.array(not dist.is_initialized())
np.savez(os.path.join(DIR, f"rank{rank}.npz"), **out)
"""


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|, on ``ref``'s device."""
    got = got.to(ref.device)
    return float((got - ref).abs().max() / ref.abs().max())


def kept_triplets(plan) -> tuple[np.ndarray, np.ndarray]:
    """The global (tri_kj, tri_ji) edge ids of the triplets a plan kept,
    read back through its local and halo slots."""
    send_idx = plan.send_idx.cpu().numpy()
    t_kj, t_ji = plan.tri_kj.cpu().numpy(), plan.tri_ji.cpu().numpy()
    t_mask = plan.tri_mask.cpu().numpy()
    el, H = plan.e_local, send_idx.shape[2]
    kjs, jis = [], []
    for d in range(t_kj.shape[0]):
        slot, ji = t_kj[d][t_mask[d]], t_ji[d][t_mask[d]]
        h = slot - el
        src = np.where(slot < el, d, h // H)
        kj = np.where(slot < el, slot,
                      send_idx[src, d, np.where(slot < el, 0, h % H)])
        kjs.append(kj + src * el)
        jis.append(ji + d * el)
    return np.concatenate(kjs), np.concatenate(jis)


def plan_npz(path, plan):
    np.savez(path, e_local=plan.e_local, halo=plan.halo,
             **{f: getattr(plan, f).cpu().numpy()
                for f in plan._fields[:5]})


def phase13_partitioned(rehearse: bool) -> dict:
    """(a) The owner-partitioned block at DimeNet's width on
    minibatch_lg's edge count: D = 1 in this process and D = 2 over two
    gloo ranks on the card, each against the dense reference on the card,
    against each other and against the CPU; a plan whose halo cap drops
    triplets against the dense reference over the triplets it kept."""
    from repro_torch.models.gnn import partitioned as tp
    E, d = P13["rehearse" if rehearse else "card"]
    T, D = 2 * E, P13_SHARDS
    rng = np.random.default_rng(13)
    tri = (rng.integers(0, E, T).astype(np.int32),
           rng.integers(0, E, T).astype(np.int32), rng.random(T) < 0.9)
    m = rng.standard_normal((E, d), dtype=np.float32)
    w = {k: (rng.standard_normal((d, d), dtype=np.float32)
             / np.float32(np.sqrt(d))) for k in ("w_tri", "w_upd")}
    t0 = time.perf_counter()
    full = tp.build_plan(*tri, E, D, E // D, T, device="cpu")
    plan_s = time.perf_counter() - t0
    drop = tp.build_plan(*tri, E, D, E // (D * P13_DROP), T, device="cpu")
    n_valid = int(tri[2].sum())
    n_full, n_drop = int(full.tri_mask.sum()), int(drop.tri_mask.sum())
    check(n_full == n_valid and 0 < n_drop < n_valid,
          f"plans kept {n_full} and {n_drop} of {n_valid} triplets")

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "inputs.npz"), m=m, **w)
        plan_npz(os.path.join(tmp, "full.npz"), full)
        plan_npz(os.path.join(tmp, "drop.npz"), drop)
        t0 = time.perf_counter()
        ranks.spawn(P13_RANK % dict(dev=str(DEV), dir=tmp), world=D,
                    store=os.path.join(tmp, "store"), env=env, timeout=600)
        spawn_s = time.perf_counter() - t0
        runs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(D)]

    md = torch.from_numpy(m).to(DEV)
    wd = {k: torch.from_numpy(v).to(DEV) for k, v in w.items()}
    tri_d = [torch.from_numpy(a).to(DEV) for a in tri]
    dense = tp.dense_triplet_block(md, *tri_d, wd)
    one_plan = tp.build_plan(*tri, E, 1, E, T, device=DEV)
    block = tp.make_triplet_block()
    peak_reset()
    with dist_mod.count_collective_bytes() as rec:
        one = block(md, one_plan, wd)
    sync()
    one_peak = peak_bytes()
    one_s, one_walls = timed_call(lambda: block(md, one_plan, wd), 3)
    cpu = tp.make_triplet_block()(
        torch.from_numpy(m), tp.build_plan(*tri, E, 1, E, T, device="cpu"),
        {k: torch.from_numpy(v) for k, v in w.items()})
    two = torch.from_numpy(np.concatenate([r["full/out"] for r in runs]))
    two_drop = torch.from_numpy(np.concatenate([r["drop/out"]
                                                for r in runs]))
    kj, ji = kept_triplets(drop)
    dense_drop = tp.dense_triplet_block(
        md, torch.from_numpy(kj).to(DEV), torch.from_numpy(ji).to(DEV),
        torch.ones(len(kj), dtype=torch.bool, device=DEV), wd)
    errs = {"D1 vs dense": rel_err(one, dense),
            "D2 vs dense": rel_err(two, dense),
            "D2 vs D1": rel_err(two, one),
            "D1 vs CPU": rel_err(one.cpu(), cpu),
            "D2 vs CPU": rel_err(two, cpu),
            "D2 drop plan vs dense over its kept triplets":
                rel_err(two_drop, dense_drop)}
    for what, e in errs.items():
        check(np.isfinite(e) and e <= P13_REL_TOL,
              f"partitioned block {what}: max |diff| / max |ref| {e} > "
              f"{P13_REL_TOL}")
    check(rec["bytes"] == 0, f"D = 1 sent {rec['bytes']} collective bytes")
    H = E // D
    for r, run in enumerate(runs):
        check(bool(run["group_destroyed"]),
              f"rank {r} exited with its process group alive")
        check(run["full/bytes"].tolist() == [D * H * d * 4, 1],
              f"rank {r} sent {run['full/bytes'].tolist()} (bytes, calls) "
              f"in the block; want [{D * H * d * 4}, 1]")
    out = dict(
        edges=E, width=d, triplets=T, valid=n_valid, shards=D, halo=H,
        drop_halo=E // (D * P13_DROP), drop_kept=n_drop, plan_host_s=plan_s,
        spawn_s=spawn_s, rel_err=errs, tolerance=P13_REL_TOL,
        one_rank=dict(ms=one_s * 1e3, walls_ms=[x * 1e3 for x in one_walls],
                      peak_bytes=one_peak),
        ranks=[dict(ms=float(np.median(run["full/ms"])),
                    walls_ms=run["full/ms"].tolist(),
                    drop_ms=float(np.median(run["drop/ms"])),
                    all_to_all_bytes=int(run["full/bytes"][0]),
                    drop_all_to_all_bytes=int(run["drop/bytes"][0]),
                    peak_bytes=int(run["full/peak"]),
                    drop_peak_bytes=int(run["drop/peak"]))
               for run in runs])
    log(f"  partitioned block, d {d}, E {E}, T {T} ({n_valid} valid): plan "
        f"{plan_s:.3f} s on the host; D = 1 {out['one_rank']['ms']:.3f} ms "
        f"(median of 3), peak {one_peak / 2**20:.1f} MiB; D = 2 over gloo "
        f"ranks {[round(r['ms'], 3) for r in out['ranks']]} ms, all_to_all "
        f"{[r['all_to_all_bytes'] for r in out['ranks']]} B, peak "
        f"{[round(r['peak_bytes'] / 2**20, 1) for r in out['ranks']]} MiB a "
        f"rank; spawn {spawn_s:.1f} s [{CARD_NAME}]")
    log(f"  drop plan (halo {out['drop_halo']} a peer) kept {n_drop} of "
        f"{n_valid}: D = 2 {[round(r['drop_ms'], 3) for r in out['ranks']]}"
        f" ms; max |diff| / max |ref| {errs} (gate {P13_REL_TOL}) "
        f"[{CARD_NAME}]")
    return out


def example_edges(name: str, ex: dict) -> int:
    """The padded edge count of an example's largest solve (the size of
    the cost array its kernel cases are drawn over)."""
    if name in ("quickstart", "image_segmentation"):
        return ex["instance"].num_edges
    if name == "serve_tiles":
        return max(t.inst.num_edges for t in ex["tickets"])
    from repro_torch.examples import distributed_multicut as dm
    return dm.PAD_EDGES


def phase13_examples(gen) -> dict:
    """(b) The four multicut examples through their ``main`` on the card,
    with their asserts, counters zeroed just before each and read just
    after: triangle_mp launched in each, cycle_intersect in each whose
    solves take the sparse path; distributed_multicut on a one-rank NCCL
    group; each kernel held against its plain version at the shapes each
    example gave it."""
    import importlib
    out = {}
    for name in P13_EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        argv = ["--device", str(DEV)]
        reset_counters()
        t0 = time.perf_counter()
        try:
            if name == "distributed_multicut":
                with one_rank_group("phase13") as group:
                    ex = mod.main(argv, group=group)
            else:
                ex = mod.main(argv)
        except AssertionError as e:
            raise SmokeFailure(f"{name}: {e}") from e
        sync()
        secs = time.perf_counter() - t0
        launches, shapes = all_launches(), path_shapes()
        check(launches["flash_attention"] == 0
              and launches["contract_matmul"] == 0,
              f"{name} launched the attention or contraction kernel")
        check(DEV.type != "cuda" or launches["triangle_mp"] > 0,
              f"{name} did not launch triangle_mp: {launches}")
        check(DEV.type != "cuda" or name not in P13_SPARSE
              or launches["cycle_intersect"] > 0,
              f"{name}'s sparse solves did not launch cycle_intersect: "
              f"{launches}")
        cases = shape_cases(shapes, {"triangle_mp": set(),
                                     "cycle_intersect": set()},
                            example_edges(name, ex), gen, name, timed=False)
        out[name] = dict(seconds=secs, launches=launches,
                         shapes=shape_record(shapes), cases=cases)
        if name == "distributed_multicut":
            out[name].update(lower_bound=ex["lower_bound"],
                             objective=ex["objective"],
                             single_device_objective=ex[
                                 "single_device_objective"],
                             quotient_nodes=ex["quotient_nodes"])
        elif name == "serve_tiles":
            out[name].update(first_calls=ex["first_calls"],
                             first_call_bound=ex["first_call_bound"],
                             wall_s=ex["wall_s"])
        log(f"  example {name}: asserts passed in {secs:.1f} s; launches "
            f"triangle_mp {launches['triangle_mp']}, cycle_intersect "
            f"{launches['cycle_intersect']}; each kernel equal to its plain "
            f"version at its {sum(len(c) for c in cases.values())} shapes "
            f"[{CARD_NAME}]")
    return out


def phase_partitioned_examples(rehearse: bool) -> dict:
    """Phase 13: (a) the owner-partitioned block, (b) the four multicut
    examples. Float32 matmuls with TF32 off, as the block's gate
    assumes. Its own generator, so the phase draws the same cases alone
    or after the others."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 13 runs float32 matmuls with TF32 off")
    gen = torch.Generator(device=DEV).manual_seed(13)
    t0 = time.perf_counter()
    out = {"partitioned": phase13_partitioned(rehearse)}
    empty_cache()
    out["examples"] = phase13_examples(gen)
    out["phase_s"] = time.perf_counter() - t0
    log(f"  phase 13 took {out['phase_s']:.1f} s [{CARD_NAME}]")
    return out


# ---------------------------------------------------------------------------
# Phase 14: the sharding plans, the pod dry-run on the host, and a sharded
# prefill on the card
# ---------------------------------------------------------------------------

# (a)'s cells, one a family, on the host over a fake group of 256 ranks;
# (b)'s gemma2-9b at 2 layers, prefill (1, S), on a one-rank mesh
P14 = {"card": dict(S=8192, cfg=dict(n_layers=2), cells=[
           ("granite-34b", "train_4k"), ("grok-1-314b", "decode_32k"),
           ("graphcast", "minibatch_lg"), ("wide-deep", "train_batch"),
           ("rama-multicut", "dist_pd")]),
       "rehearse": dict(S=128, cfg=dict(
           n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
           d_ff=128, vocab=256, local_window=16), cells=[
           ("grok-1-314b", "long_500k"), ("egnn", "full_graph_sm"),
           ("wide-deep", "serve_p99"), ("rama-multicut", "dist_pd")])}
P14_HOST = """
import dataclasses, json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.configs.base import ShapeCell, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
spec = json.loads(sys.argv[1])
out = {"cells": [], "failures": []}
t0 = time.perf_counter()
with dryrun.fake_group(256):
    mesh = dryrun.production_mesh()
    for aid, sname in spec["cells"]:
        try:
            out["cells"].append(dryrun.dryrun_cell(aid, sname, mesh,
                                                   verbose=False))
        except Exception as e:
            out["failures"].append([aid, sname, repr(e)[:400]])
    del mesh
out["cells_s"] = time.perf_counter() - t0
with dryrun.fake_group(1):
    mesh = make_debug_mesh(1, 1, device_type="cpu")
    arch = get_arch("gemma2-9b")
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg,
                                                             **spec["cfg"]))
    shape = ShapeCell("prefill_card", "prefill",
                      dict(seq_len=spec["S"], global_batch=1))
    out["card_cell"] = dryrun.dryrun_cell("gemma2-9b", "prefill_card", mesh,
                                          arch=arch, shape=shape,
                                          verbose=False)
    del mesh
print(json.dumps(out))
"""


def phase14_host(key: str):
    """(a) started: the dry-run of one cell a family, and of (b)'s cell on
    a one-rank mesh, in a child process on the host (it holds a fake
    group of its own, and runs while (b) uses the card)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    spec = {k: P14[key][k] for k in ("S", "cfg", "cells")}
    return subprocess.Popen([sys.executable, "-c", P14_HOST,
                             json.dumps(spec)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True), time.perf_counter()


def phase14_card(key: str) -> dict:
    """(b) gemma2-9b at 2 layers of full width, prefill (1, S), its
    float32 master params placed as DTensors by its plan on a one-rank
    mesh of the card: the logits against the plain one-card prefill, the
    flash kernel launched through ``local_map``, the live argument bytes,
    and the same step through the plain attention counted by
    ``FlopCounterMode`` and the dry-run's counter, with its peak memory."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.roofline.solver import LocalWorkCounter
    from repro_torch.sharding import clear_dtensor_caches, distribute, \
        local_bytes
    S = P14[key]["S"]
    arch = get_arch("gemma2-9b")
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, **P14[key]["cfg"]))
    gen = torch.Generator(device=DEV).manual_seed(14)
    out = {}
    with one_rank_group("phase14"):
        mesh = make_debug_mesh(1, 1, device_type=DEV.type)
        a = arch.for_mesh(mesh)
        shape = ShapeCell("prefill_card", "prefill",
                          dict(seq_len=S, global_batch=1))
        params = tfm.init_params(a.cfg, gen, DEV, masters=True)
        tokens = torch.randint(0, a.cfg.vocab, (1, S), generator=gen,
                               device=DEV, dtype=torch.int32)
        step = a.step_fn(shape)
        with torch.no_grad():
            plain = step(params, tokens)
        ss, ish = a.state_shardings(mesh, shape), a.input_shardings(mesh,
                                                                    shape)

        def place(tree, sh):
            if isinstance(tree, dict):
                return {k: place(v, sh[k]) for k, v in tree.items()}
            return distribute(tree, sh)

        dparams = place(params, ss["params"])
        dtok = distribute(tokens, ish["tokens"])
        out["argument_bytes_live"] = local_bytes(dparams) + local_bytes(dtok)
        reset_counters()
        t0 = time.perf_counter()
        with torch.no_grad(), implicit_replication():
            got = step(dparams, dtok)
        sync()
        out["sharded_prefill_s"] = time.perf_counter() - t0
        out["flash_launches"] = all_launches()["flash_attention"]
        check(out["flash_launches"] == a.cfg.n_layers or DEV.type != "cuda",
              f"sharded prefill launched flash_attention "
              f"{out['flash_launches']} times for {a.cfg.n_layers} layers")
        gl = got.to_local()
        out["bit_equal"] = bool(torch.equal(gl, plain))
        out["logits"] = logits_diff(gl, plain)
        check(out["bit_equal"], f"sharded prefill logits differ from the "
              f"plain prefill's: {out['logits']}")
        del got, gl, plain
        empty_cache()
        ref = a.step_fn(shape, backend="reference")
        with torch.no_grad(), implicit_replication():
            ref(dparams, dtok)                  # DTensor's caches warm
            with FlopCounterMode(display=False) as fc:
                ref(dparams, dtok)
            with LocalWorkCounter(external=[dparams, dtok]) as wc:
                ref(dparams, dtok)
            sync()
            empty_cache()
            resident = torch.cuda.memory_allocated() \
                if DEV.type == "cuda" else 0
            peak_reset()
            ref(dparams, dtok)
            sync()
        out["flop_counter_flops"] = int(fc.get_total_flops())
        out["counter_flops"] = int(wc.flops)
        out["step_peak_bytes"] = peak_bytes() - resident \
            + out["argument_bytes_live"]
        del dparams, dtok, params, mesh, a, ss, ish
        clear_dtensor_caches()
        import gc
        gc.collect()
    return out


def phase_plans(rehearse: bool) -> dict:
    """Phase 14: (a) the pod dry-run of one cell a family on the host (a
    fake group of 256 ranks), (b) gemma2-9b's sharded prefill on the card
    held against the plain prefill and against the dry-run of the same
    cell."""
    key = "rehearse" if rehearse else "card"
    t0 = time.perf_counter()
    proc, started = phase14_host(key)
    try:
        out = {"card": phase14_card(key)}
    finally:
        stdout, stderr = proc.communicate(timeout=900)
    host = time.perf_counter() - started
    check(proc.returncode == 0, f"phase 14 (a) dry-run exited "
          f"{proc.returncode}: {stderr[-2000:]}")
    dry = json.loads(stdout.strip().splitlines()[-1])
    check(not dry["failures"], f"phase 14 (a) cells failed: "
          f"{dry['failures']}")
    for rec in dry["cells"]:
        log(f"  dry-run [{rec['mesh']}] {rec['arch']}/{rec['shape']}: "
            f"trace {rec['compile_s']} s on the host, {rec['flops']:.4g} "
            f"flops, {rec['bytes_accessed']:.4g} B, args "
            f"{rec['argument_size_bytes']} B, out "
            f"{rec['output_size_bytes']} B, temp {rec['temp_size_bytes']} "
            f"B, peak {rec['peak_bytes_per_device']} B, collectives "
            f"{rec['collectives']['total']} B a rank ({rec['trace']}) "
            f"[{CARD_NAME}]")
    card, cell = out["card"], dry["card_cell"]
    log(f"  (a) {len(dry['cells'])} cells traced in {dry['cells_s']:.1f} s, "
        f"0 failures; the child ran {host:.1f} s [{CARD_NAME}]")
    log(f"  (b) gemma2-9b {P14[key]['cfg'].get('n_layers')} layers, prefill"
        f" (1, {P14[key]['S']}) with DTensor params by its plan: logits "
        f"bit-equal {card['bit_equal']} to the plain prefill "
        f"({card['logits']}), flash_attention launched "
        f"{card['flash_launches']} times through local_map, "
        f"{card['sharded_prefill_s']:.3f} s [{CARD_NAME}]")
    check(cell["argument_size_bytes"] == card["argument_bytes_live"],
          f"dry-run argument bytes {cell['argument_size_bytes']} != live "
          f"{card['argument_bytes_live']}")
    check(cell["matmul_flops"] == card["flop_counter_flops"],
          f"dry-run matmul flops {cell['matmul_flops']} != FlopCounterMode "
          f"{card['flop_counter_flops']}")
    check(cell["flops"] == card["counter_flops"],
          f"dry-run flops {cell['flops']} != the counter on the card "
          f"{card['counter_flops']}")
    ratio = cell["peak_bytes_per_device"] / max(card["step_peak_bytes"], 1)
    log(f"  (b) dry-run of the same cell: argument bytes "
        f"{cell['argument_size_bytes']} = live {card['argument_bytes_live']};"
        f" flops {cell['matmul_flops']:.6g} = FlopCounterMode "
        f"{card['flop_counter_flops']:.6g} (all ops {cell['flops']:.6g} = "
        f"{card['counter_flops']:.6g}); predicted peak "
        f"{cell['peak_bytes_per_device']} B vs measured "
        f"{card['step_peak_bytes']} B (ratio {ratio:.3f}, reported, not a "
        f"gate) [{CARD_NAME}]")
    out.update(dry=dry, host_s=host, peak_ratio=ratio,
               phase_s=time.perf_counter() - t0)
    log(f"  phase 14 took {out['phase_s']:.1f} s [{CARD_NAME}]")
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
                lm: dict, dense: dict, served: dict, traced: dict,
                sharded: dict, shards: dict, moe_train: dict,
                gnn_recsys: dict, examples: dict) -> dict:
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
            every = cases[name] + moe_train["flash_cases"]
            rows.append(dict(
                name=name, route="cuda", source=meta["source"],
                replaces=meta["replaces"],
                launches=lm["launches"][name],
                moe_prefill_launches={
                    aid: r["launches"][name]
                    for aid, r in moe_train["moe"].items()},
                train_step_launches=moe_train["train"]["launches_per_step"],
                max_abs_err=max(c["max_abs_err"] for c in every),
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
                cases=every))
            continue
        shapes = main["main_shapes"][name]
        top = max(shapes, key=shapes.get)       # most launched shape
        key = [top, 3] if name == "triangle_mp" else \
            [[top[0], top[1]], [top[0], top[2]]]
        head = next(c for c in main_cases[name] if c["shape"] == key)
        gm = gnn_recsys["gnn_multicut"]
        every = (cases[name] + main_cases[name]
                 + sharded["one_rank"]["cases"][name]
                 + shards["separation"]["cases"][name]
                 + shards["batch"]["cases"][name]
                 + gm["cases"][name]
                 + [c for ex in examples.values()
                    for c in ex["cases"][name]])
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
            engine_launches=served["stream"]["launches"][name],
            traced_launches=traced["traced_main"]["launches"][name],
            profiled_round_launches=traced["roofline"]["round_launches"][
                name],
            mp_sweep_1m_launches=traced["roofline"]["cells"][
                "mp_sweep_1m"]["launches"][name],
            sharded_launches=sharded["one_rank"]["launches"][name],
            two_rank_launches=[r["launches"][name]
                               for r in sharded["two_ranks"]["ranks"]],
            separation_sharded_launches={
                S: shards["separation"][S]["launches"][name]
                for S in P10_SHARDS},
            batch_sharded_launches={
                S: shards["batch"][S]["launches"][name]
                for S in P10_SHARDS},
            gnn_multicut_launches=gm["launches"][name],
            examples_launches={ex: r["launches"][name]
                               for ex, r in examples.items()},
            work=head["work"],
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
        log("phase 7: the solve server")
        record["serve"] = phase_serve(args.rehearse,
                                      api.SolverConfig().max_neg)
        log("phase 8: solve traces, Table 1, streamed ingest, roofline")
        record["trace"] = phase_trace(main_rec, record["dense"], gen,
                                      args.rehearse)
        log("phase 9: the edge-range-sharded solve and the block "
            "decomposition")
        record["sharded"] = phase_sharded(main_rec, gen, args.rehearse)
        log("phase 10: separation and batch sharding over copies of the "
            "card, the sharded round's roofline")
        record["shards"] = phase_shards(main_rec, main_cases,
                                        record["sharded"], gen,
                                        args.rehearse)
        log("phase 11: MoE serving (llama4-scout, grok-1) and the LM train "
            "step (gemma2-9b)")
        record["moe_train"] = phase_moe_train(args.rehearse)
        log("phase 12: the sparse substrate's families: wide-deep, the GNN "
            "train steps, GraphCast's weather path, gnn_multicut")
        record["gnn_recsys"] = phase_gnn_recsys(args.rehearse)
        log("phase 13: the owner-partitioned DimeNet block over "
            "torch.distributed, the four multicut examples")
        record["partitioned_examples"] = phase_partitioned_examples(
            args.rehearse)
        log("phase 14: the sharding plans: the pod dry-run on the host, a "
            "sharded prefill on the card")
        record["plans"] = phase_plans(args.rehearse)
        line = kernel_line(cases, main_cases, main_rec, record["lm"],
                           record["dense"], record["serve"],
                           record["trace"], record["sharded"],
                           record["shards"], record["moe_train"],
                           record["gnn_recsys"],
                           record["partitioned_examples"]["examples"])
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    if args.rehearse:
        print("chip_smoke: rehearsal finished on the CPU; no result",
              file=sys.stderr)
        return 3
    for k in ("main_shapes", "_inst", "_result"):
        del record["main_path"][k]
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
