"""Per-phase roofline attribution of one solver round (port of
``repro.roofline.solver``, one card).

One round is split at the phase boundaries the solver itself uses
(separation, message passing, contraction); each phase runs standalone at
the shapes of the solve's round 0 and feeds the next phase its real
outputs, so a regression localises to a phase.

How each number is taken, where the reference reads XLA's cost analysis:

* **Wall:** the min of 5 runs after a warm-up, each timed by CUDA events
  on a card (by the host clock on the CPU, which the record names).
* **Flops and bytes of PyTorch ops:** a :class:`WorkCounter` (a
  ``TorchDispatchMode``) sees every aten op the phase runs. Views and
  allocations move nothing and are skipped, as is a ``copy_`` onto
  itself; every other op counts each distinct tensor it reads once and
  each tensor it writes once (an in-place op's result is its first input:
  one read and one write), except that an in-place scatter (``index_put_``,
  ``index_fill_``, ``scatter_*_``, ``index_add_``) touches only the
  elements it updates: its other inputs are read once and each updated
  element is written once (read and written by an accumulating one);
  and a gather (``index``, ``index_select``, ``gather``) reads from its
  source only the elements it returns.
  Arithmetic ops count one flop per output
  element (a reduction one per input element, a scatter one per source
  element, an accumulating ``index_put_`` included); matmuls count
  2·m·n·k through ``torch.utils.flop_counter``.
* **Compute term:** the count is held against ``Hardware.peak_flops``,
  the card's dense bf16 tensor-core peak. Most of a round's ops are fp32
  and int32 element-wise work that runs far below that peak, so the
  compute term is a floor, not an estimate, for them.
* **The hand kernels** launch through ``ctypes``, out of the dispatcher's
  sight: their launch counters and shape logs are read before and after
  the phase, and each launch adds its ``work()`` (the kernel's own reads,
  writes and ops, from ``kernels/*/ops.py``). The ops their wrappers
  run around a launch (sorts, buffer fills, the lower bound) are
  PyTorch ops and are counted by the mode, each once.
* **Loop correction:** the reference's cost analysis counts a loop body
  once, so it extrapolates the MP phase from depths 1 and 2
  (:func:`loop_corrected`). In eager torch the depth-``mp_iters`` count is
  also taken directly; the profile asserts the two agree.
* **A sharded round** (``cfg.state_shards``, :func:`profile_solve_round`
  called by every rank of the default process group, as the solve is):
  each rank of the state group counts its own three phases at the local
  shapes the sharded solve carries, and its collective bytes from what
  the port's collectives send (:func:`repro_torch.core.dist.
  count_collective_bytes`). The reference reads one SPMD program and
  multiplies by S; here the ranks are real, so the job totals are each
  count summed over the group, the per-device numbers its maximum over
  the ranks (the roofline terms use those: the ranks run at once), and
  the wall the slowest rank's.
"""
from __future__ import annotations

import time
from collections import Counter

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core.contraction import (
    choose_contraction_set, choose_contraction_set_sharded, contract,
    contract_csr, contract_sharded,
)
from repro_torch.core.cycles import separate
from repro_torch.core.dist import (
    all_max, all_min, all_sum_int, count_collective_bytes, state_group,
)
from repro_torch.core.graph import (
    MulticutInstance, build_csr, csr_from_instance, resolve_graph_impl,
)
from repro_torch.core.message_passing import run_message_passing_sharded
from repro_torch.core.solver import SolverConfig, resolve_intersect, \
    resolve_mp
from repro_torch.kernels.cycle_intersect import ops as isect_ops
from repro_torch.kernels.triangle_mp import ops as mp_ops
from repro_torch.roofline.analysis import (
    HW, Hardware, dominant_term, roofline_terms, step_time_estimate,
)

PHASES = ("separation", "message_passing", "contraction")

# ops that move no data: allocations and metadata
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "lift_fresh", "detach", "alias",
            "set_", "resize_", "record_stream"}
_REDUCTIONS = {"sum", "mean", "prod", "amin", "amax", "min", "max",
               "argmin", "argmax", "any", "all", "logsumexp", "norm"}
_SCATTERS = {"scatter", "scatter_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_", "index_add",
             "index_add_", "index_put", "index_put_", "_index_put_impl_"}
# in-place scatters: (name, whether each update reads the old value too;
# ``index_put_`` does when its ``accumulate`` argument is true)
_INPLACE_SCATTERS = {"index_put_": False, "_index_put_impl_": False,
                     "index_fill_": False, "scatter_": False,
                     "scatter_add_": True, "scatter_reduce_": True,
                     "index_add_": True}
_INDEX_PUTS = {"index_put", "index_put_", "_index_put_impl_"}
_GATHERS = {"index", "index_select", "gather", "take"}
_ARITH = _REDUCTIONS | {
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "neg", "abs", "minimum", "maximum", "clamp", "clamp_", "clamp_min",
    "clamp_min_", "clamp_max", "clamp_max_", "where", "cumsum", "cumsum_",
    "cumprod", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "remainder", "fmod",
    "floor_divide", "pow", "sqrt", "rsqrt", "exp", "log", "sign",
    "reciprocal", "floor", "ceil", "round", "trunc", "sigmoid", "tanh",
    "isinf", "isnan", "isfinite", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_add", "index_add_"}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a tensor occupies: its elements, but no more than its storage
    (an expanded view reads its storage, not its broadcast size)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


class WorkCounter(TorchDispatchMode):
    """Counts the flops and bytes of the aten ops run under it (see the
    module docstring for the rules). ``flops``, ``bytes`` and ``ops``
    (the ops counted) accumulate."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_DATA:
            return
        ins = [t for t in tree_leaves((args, {k: v for k, v in
                                              kwargs.items() if k != "out"}))
               if isinstance(t, torch.Tensor)]
        if name == "copy_" and ins[0].data_ptr() == ins[1].data_ptr():
            return                                  # a copy onto itself
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        accumulate = name in _INDEX_PUTS and bool(
            args[3] if len(args) > 3 else kwargs.get("accumulate", False))
        if name in _INPLACE_SCATTERS:
            b = self._scatter_bytes(name, ins, args, accumulate)
        elif name in _GATHERS:
            # the indices read once, the gathered elements read and written
            b = sum(_nbytes(t) for t in {id(t): t for t in ins[1:]
                                         if t is not ins[0]}.values()) \
                + 2 * sum(_nbytes(t) for t in outs)
        else:
            seen = set()
            b = 0
            for t in ins:
                if id(t) not in seen:
                    seen.add(id(t))
                    b += _nbytes(t)
            written = set()
            for t in outs:
                if id(t) not in written:
                    written.add(id(t))
                    b += _nbytes(t)
        if func.overloadpacket in flop_registry:
            f = flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        elif name in _ARITH or accumulate:
            if name in _REDUCTIONS:
                f = max((t.numel() for t in ins), default=0)
            elif name in _SCATTERS:
                f = ins[-1].numel()
            else:
                f = max((t.numel() for t in outs), default=0)
        else:
            f = 0
        self.flops += int(f)
        self.bytes += b
        self.ops += 1

    @staticmethod
    def _scatter_bytes(name: str, ins: list, args: tuple,
                       accumulate: bool) -> int:
        """Bytes of an in-place scatter into ``self`` (its first input):
        the other inputs read once, each updated element of ``self``
        written once (and read once more when the update accumulates:
        always for the adding and reducing scatters, for ``index_put_``
        when ``accumulate`` is true).
        ``index_fill_`` updates a whole slice along ``dim`` per index."""
        self_t = ins[0]
        rest = {id(t): t for t in ins[1:] if t is not self_t}
        b = sum(_nbytes(t) for t in rest.values())
        if name == "index_fill_":
            dim = args[1] % max(self_t.dim(), 1)
            per = self_t.numel() // max(self_t.shape[dim], 1) \
                if self_t.dim() else 1
            updated = args[2].numel() * per
        else:
            updated = max((t.numel() for t in rest.values()), default=0)
        k = 2 if _INPLACE_SCATTERS[name] or accumulate else 1
        return b + k * updated * self_t.element_size()


class LocalWorkCounter(WorkCounter):
    """A :class:`WorkCounter` that counts where the local ops run: an op
    on DTensors is passed on (``NotImplemented``) to DTensor, whose local
    ops it then counts on each rank's shards, so flops and bytes are per
    rank, not global. DTensor's sharding propagation runs each new op
    signature once on global fake tensors to learn its output's shape;
    those runs are not counted. ``matmul_flops`` is the part of ``flops``
    that ``torch.utils.flop_counter`` counts (``FlopCounterMode``'s own
    formulas: matmuls, convolutions, attention). Each
    ``_c10d_functional`` collective is recorded in ``collectives`` as
    (kind, result bytes), not counted as an op (see
    ``repro_torch.roofline.analysis.collective_bytes``).

    It also tracks the storages the counted ops allocate: ``live_bytes``
    and its high-water mark ``peak_bytes`` (a storage is freed when its
    last tensor goes; those of ``external``, the step's arguments, are not
    the step's)."""

    def __init__(self, external=()):
        super().__init__()
        self.matmul_flops = 0
        self.collectives = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}
        self._external = {t.untyped_storage()._cdata
                          for t in _local_leaves(external)}
        self._paused = 0
        self._unpatch = None

    def _free(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, out):
        import weakref
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._external:
                continue
            self._live[key] = st.nbytes()
            self.live_bytes += self._live[key]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def __enter__(self):
        from torch.distributed.tensor import _redistribute
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        counter = self
        patched = []

        def pause(owner, name):
            orig = getattr(owner, name)

            def uncounted(*args, **kwargs):
                counter._paused += 1
                try:
                    return orig(*args, **kwargs)
                finally:
                    counter._paused -= 1

            setattr(owner, name, uncounted)
            patched.append((owner, name, orig))

        # DTensor's planning (sharding propagation, its fake runs of each
        # new op on global shapes, redistribution plans) runs ops only
        # when its caches miss: none of it is the step's work
        pause(ShardingPropagator, "_propagate_tensor_meta_non_cached")
        pause(ShardingPropagator, "propagate_op_sharding_non_cached")
        pause(_redistribute, "_gen_transform_infos_non_cached")

        def unpatch():
            for owner, name, orig in reversed(patched):
                setattr(owner, name, orig)
        self._unpatch = unpatch
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unpatch()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        ns = func.namespace
        if ns == "_c10d_functional":
            from repro_torch.roofline.analysis import C10D_KINDS
            kind = C10D_KINDS.get(func.overloadpacket.__name__)
            if kind is not None:
                self.collectives.append((kind, sum(
                    _nbytes(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))))
            return out
        if ns in ("c10d", "prim"):
            return out
        if func.overloadpacket in flop_registry:
            self.matmul_flops += int(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        self._count(func, args, kwargs, out)
        self._track(out)
        return out


def _local_leaves(tree) -> list:
    """The tensors of a tree, a DTensor's local shard in its place."""
    from repro_torch.sharding import is_dtensor
    return [t.to_local() if is_dtensor(t) else t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _kernel_state() -> tuple:
    return (mp_ops.launches, Counter(mp_ops.shapes), isect_ops.launches,
            Counter(isect_ops.shapes))


def count_work(fn, *args, mp_inputs=None) -> tuple[dict, object]:
    """Run ``fn(*args)`` once under a :class:`WorkCounter` and add the
    ``work()`` of each hand-kernel launch it made. ``mp_inputs`` =
    (cost, edge_valid, tri, tri_valid, iters) are the inputs of the one
    ``mp_phase`` call ``fn`` makes, if it makes one (that kernel's work
    depends on its data, not only its shapes), or a function of no
    arguments that returns them once ``fn`` has run. Returns (counts,
    fn's result)."""
    before = _kernel_state()
    with WorkCounter() as wc:
        res = fn(*args)
    after = _kernel_state()
    k_flops = k_bytes = 0
    mp_launches = after[0] - before[0]
    if mp_launches:
        calls = sum((after[1] - before[1]).values())
        if mp_inputs is None or calls != 1:
            raise ValueError(f"count_work: {mp_launches} triangle_mp "
                             f"launches in {calls} calls; need the inputs "
                             f"of exactly one mp_phase call")
        if callable(mp_inputs):
            mp_inputs = mp_inputs()
        cost, ev, tri, valid, iters = mp_inputs
        f, b = mp_ops.work(cost, tri, valid, iters)
        k_flops += f
        k_bytes += b
    isect_launches = after[2] - before[2]
    if isect_launches:
        shapes = after[3] - before[3]
        if sum(shapes.values()) != isect_launches:
            raise ValueError(f"count_work: {isect_launches} cycle_intersect "
                             f"launches, {sum(shapes.values())} calls "
                             f"logged")
        for (R, W, Wj), n in shapes.items():
            f, b = isect_ops.work(R, W, Wj)
            k_flops += n * f
            k_bytes += n * b
    counts = dict(flops=wc.flops + k_flops, bytes_accessed=wc.bytes + k_bytes,
                  collective_bytes=0, torch_ops=wc.ops,
                  kernel_flops=k_flops, kernel_bytes=k_bytes,
                  kernel_launches=dict(triangle_mp=mp_launches,
                                       cycle_intersect=isect_launches))
    return counts, res


def loop_corrected(x1: float, x2: float, iters: int) -> float:
    """Two-point trip-count correction: cost at depth ``iters`` from the
    depth-1 and depth-2 measurements (setup + per-iteration delta)."""
    return x1 + (iters - 1) * (x2 - x1)


def _wall(fn, *args, device: torch.device, warmup: int = 1,
          iters: int = 5) -> float:
    """Min seconds of ``iters`` runs after ``warmup``: CUDA events on a
    card, the host clock on the CPU."""
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(iters):
        if device.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(*args)
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return min(ts)


def _phase_record(counts: dict, wall_s: float, hw: Hardware) -> dict:
    terms = roofline_terms(counts["flops"], counts["bytes_accessed"],
                           counts["collective_bytes"], hw)
    roof = step_time_estimate(terms)
    return {**counts, "wall_s": wall_s, "terms": terms,
            "dominant": dominant_term(terms), "roofline_s": roof,
            "bound_share": roof / wall_s if wall_s > 0 else None}


def profile_solve_round(inst: MulticutInstance,
                        cfg: SolverConfig = SolverConfig(),
                        backend: str | None = None,
                        hw: Hardware = HW) -> dict:
    """Per-phase flops/bytes/wall attribution of one separation + message
    passing + contraction round on ``inst`` (on its device) under ``cfg``,
    through ``backend``'s phase functions (the hand kernels by default).
    The per-phase walls exclude what runs between phases, so their sum
    bounds the round from above. A config with ``state_shards`` profiles
    the edge-range-sharded round (:func:`_profile_solve_round_sharded`)."""
    if cfg.state_shards:
        return _profile_solve_round_sharded(inst, cfg, backend, hw)
    dev = inst.device
    impl = resolve_graph_impl(cfg.graph_impl, inst.num_nodes,
                              cfg.sparse_threshold)
    mp = resolve_mp(backend)
    intersect = resolve_intersect(backend)
    phases = {}

    def record(name, fn, *args, mp_inputs=None):
        counts, out = count_work(fn, *args, mp_inputs=mp_inputs)
        phases[name] = _phase_record(counts, _wall(fn, *args, device=dev),
                                     hw)
        return out

    # --- separation: the first round's shape (4/5-cycles exactly when the
    # solver's first PD round runs them under this cfg)
    with45 = cfg.always_cycles45 or cfg.first_round_cycles45

    def sep_fn(i, c):
        return separate(i, max_neg=cfg.max_neg,
                        max_tri_per_edge=cfg.max_tri_per_edge,
                        with_cycles45=with45, nbr_k=cfg.nbr_k,
                        graph_impl=impl, sparse_row_cap=cfg.sparse_row_cap,
                        sparse_row_cap_short=cfg.sparse_row_cap_short,
                        sparse_threshold=cfg.sparse_threshold,
                        intersect=intersect, csr=c,
                        separation_chunk=cfg.separation_chunk,
                        separation_shards=cfg.separation_shards)

    csr = csr_from_instance(inst) if impl == "sparse" else None
    sep = record("separation", sep_fn, inst, csr)

    # --- message passing: counted at depths 1 and 2 and extrapolated, as
    # the reference does, and at depth mp_iters directly
    inst2 = sep.instance
    tri, tri_ok = sep.triangles.edges, sep.triangles.valid

    def mp_at(depth):
        return count_work(mp, inst2.cost, inst2.edge_valid, tri, tri_ok,
                          depth, mp_inputs=(inst2.cost, inst2.edge_valid,
                                            tri, tri_ok, depth))

    (d1, _), (d2, _) = mp_at(1), mp_at(2)
    direct, (_, c_rep, _) = mp_at(cfg.mp_iters)
    for k in ("flops", "bytes_accessed"):
        extrapolated = loop_corrected(d1[k], d2[k], cfg.mp_iters)
        if extrapolated != direct[k]:
            raise AssertionError(
                f"profile_solve_round: message passing {k} at depth "
                f"{cfg.mp_iters}: {direct[k]} counted, {extrapolated} "
                f"extrapolated from depths 1 and 2")
    rec = _phase_record(direct, _wall(mp, inst2.cost, inst2.edge_valid, tri,
                                      tri_ok, cfg.mp_iters, device=dev), hw)
    rec["loop"] = {"iters": cfg.mp_iters,
                   "flops_depth1": d1["flops"], "flops_depth2": d2["flops"],
                   "bytes_depth1": d1["bytes_accessed"],
                   "bytes_depth2": d2["bytes_accessed"]}
    phases["message_passing"] = rec

    # --- contraction
    inst3 = inst2._replace(cost=c_rep)

    def con_fn(i):
        S = choose_contraction_set(i, matching_rounds=cfg.matching_rounds,
                                   forest_rounds=cfg.forest_rounds,
                                   switch_frac=cfg.switch_frac,
                                   contract_frac=cfg.contract_frac)
        return contract_csr(i, S)[0] if impl == "sparse" else contract(i, S)

    record("contraction", con_fn, inst3)

    return {
        "impl": impl,
        "hw": hw.name,
        "device": str(dev),
        "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
        "mp_iters": cfg.mp_iters,
        "phases": phases,
        "round_wall_s": sum(p["wall_s"] for p in phases.values()),
        "round_roofline_s": sum(p["roofline_s"] for p in phases.values()),
    }


# ---------------------------------------------------------------------------
# The edge-range-sharded round
# ---------------------------------------------------------------------------

_SUMMED = ("flops", "bytes_accessed", "collective_bytes", "torch_ops",
           "kernel_flops", "kernel_bytes")


def _sharded_phase_record(counts: dict, wall_s: float, hw: Hardware,
                          group, device) -> dict:
    """Phase record of one rank's ``counts`` over the state group: the
    whole-job totals (each count summed over the ranks, by
    ``all_sum_int``), ``*_per_device`` (its maximum over the ranks) and
    this rank's own ``rank_*``; ``same_on_every_rank`` says whether every
    count agreed, which makes the job exactly per-device × S, the
    reference's identity. The roofline terms use the per-device numbers
    and the wall is the slowest rank's: the ranks run at once."""
    mine = torch.tensor([counts[k] for k in _SUMMED], dtype=torch.int64,
                        device=device)
    job = all_sum_int(mine, group).tolist()
    top = all_max(mine, group).tolist()
    low = all_min(mine, group).tolist()
    wall = float(all_max(torch.tensor([wall_s], dtype=torch.float64,
                                      device=device), group)[0])
    rec = dict(zip(_SUMMED, job))
    for k, hi, mn in zip(_SUMMED, top, low):
        rec[f"{k}_per_device"] = hi
        rec[f"rank_{k}"] = counts[k]
    rec["same_on_every_rank"] = top == low
    rec["kernel_launches"] = counts["kernel_launches"]
    rec["collective_calls"] = counts["collective_calls"]
    terms = roofline_terms(rec["flops_per_device"],
                           rec["bytes_accessed_per_device"],
                           rec["collective_bytes_per_device"], hw)
    roof = step_time_estimate(terms)
    return {**rec, "wall_s": wall, "rank_wall_s": wall_s, "terms": terms,
            "dominant": dominant_term(terms), "roofline_s": roof,
            "bound_share": roof / wall if wall > 0 else None}


def _count_rank(fn, *args, mp_inputs=None) -> tuple[dict, object]:
    """:func:`count_work` with this rank's collective bytes."""
    with count_collective_bytes() as sent:
        counts, out = count_work(fn, *args, mp_inputs=mp_inputs)
    counts["collective_bytes"] = sent["bytes"]
    counts["collective_calls"] = sent["calls"]
    return counts, out


def _profile_solve_round_sharded(inst, cfg: SolverConfig,
                                 backend: str | None, hw: Hardware):
    """Per-phase attribution of one edge-range-partitioned PD round
    (:mod:`repro_torch.core.sharded`), called by every rank of the default
    process group (or alone, without one). Each rank of the state group
    runs separation, message passing and contraction at exactly the local
    shapes ``solve_state_sharded`` carries, each phase fed the previous
    one's real outputs; ranks past the state group take no part and get
    None.

    As in the reference, the separation record includes the local CSR
    build (the solve builds it once and carries it through contraction)
    and MP is counted at depths 1 and 2 and extrapolated, here also
    counted at depth ``mp_iters`` and checked against the extrapolation,
    collective bytes included. Records: :func:`_sharded_phase_record`."""
    from repro_torch.core.sharded import (
        _rank_range, _separate_triangles_state_sharded,
        validate_state_sharded,
    )
    shards = validate_state_sharded(inst, cfg, "pd")
    group = state_group(shards)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank >= shards:
        return None
    dev = inst.device
    N = inst.num_nodes
    mp = resolve_mp(backend)
    intersect = resolve_intersect(backend)
    u, v, c, ev = _rank_range(inst, shards, rank)
    nv = inst.node_valid
    phases = {}

    def record(name, counts, wall_fn, *args):
        phases[name] = _sharded_phase_record(
            counts, _wall(wall_fn, *args, device=dev), hw, group, dev)

    # --- separation, the local CSR build included
    def sep_fn(u_, v_, c_, ev_):
        csr = build_csr(u_, v_, ev_, N)
        return _separate_triangles_state_sharded(u_, v_, c_, ev_, csr, N,
                                                 cfg, shards, group,
                                                 intersect)

    counts, (tri, tri_ok) = _count_rank(sep_fn, u, v, c, ev)
    record("separation", counts, sep_fn, u, v, c, ev)

    # --- message passing at depths 1, 2 and mp_iters
    def mp_at(depth):
        seen = {}

        def mp_seen(*a):
            seen["inputs"] = a
            return mp(*a)

        return _count_rank(run_message_passing_sharded, c, ev, tri, tri_ok,
                           depth, shards, group, mp_seen,
                           mp_inputs=lambda: seen["inputs"])

    (d1, _), (d2, _) = mp_at(1), mp_at(2)
    direct, (c_rep, _) = mp_at(cfg.mp_iters)
    for k in ("flops", "bytes_accessed", "collective_bytes"):
        extrapolated = loop_corrected(d1[k], d2[k], cfg.mp_iters)
        if extrapolated != direct[k]:
            raise AssertionError(
                f"profile_solve_round (sharded): message passing {k} at "
                f"depth {cfg.mp_iters}: {direct[k]} counted, {extrapolated}"
                f" extrapolated from depths 1 and 2")
    record("message_passing", direct, run_message_passing_sharded, c, ev,
           tri, tri_ok, cfg.mp_iters, shards, group, mp)
    phases["message_passing"]["loop"] = {
        "iters": cfg.mp_iters,
        "flops_depth1": d1["flops"], "flops_depth2": d2["flops"],
        "bytes_depth1": d1["bytes_accessed"],
        "bytes_depth2": d2["bytes_accessed"]}

    # --- contraction
    def con_fn(u_, v_, c_, ev_, nv_):
        S_loc = choose_contraction_set_sharded(
            u_, v_, c_, ev_, nv_, cfg.matching_rounds, cfg.forest_rounds,
            cfg.switch_frac, cfg.contract_frac, shards, group)
        return contract_sharded(u_, v_, c_, ev_, nv_, S_loc, shards, group)

    counts, _ = _count_rank(con_fn, u, v, c_rep, ev, nv)
    record("contraction", counts, con_fn, u, v, c_rep, ev, nv)

    return {
        "impl": "sparse",
        "hw": hw.name,
        "device": str(dev),
        "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
        "mp_iters": cfg.mp_iters,
        "state_shards": shards,
        "rank": rank,
        "phases": phases,
        "round_wall_s": sum(p["wall_s"] for p in phases.values()),
        "round_roofline_s": sum(p["roofline_s"] for p in phases.values()),
    }
