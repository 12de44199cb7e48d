"""Multicut solver API of the PyTorch/CUDA port (mirrors ``repro.api``).

    from repro_torch import api
    from repro_torch.core.graph import grid_instance

    inst = grid_instance(512, 1024)           # on cuda by default
    res = api.solve(inst)                     # paper PD, hand kernels
    res = api.solve(inst, preset="pd-chunked")
    mc = api.Multicut.from_preset("paper-pd+")
    res = mc.solve(inst)

    batch = api.stack_instances([inst0, inst1, ...])
    results = api.unstack_results(mc.solve_batch(batch))

    res, state = api.solve_with_state(inst)   # open a delta session
    res, state = api.solve_delta(state, api.make_patch(
        inst.num_nodes, reweight=(u, v, c)), warm=True)

**Device.** Entry points run on the card: ``make_instance``/the
generators, :func:`make_patch`, :func:`solve`, :func:`solve_batch`,
:func:`solve_with_state` and :func:`solve_delta` put tensors on ``cuda``
unless ``device=`` names another device, and raise when no card is
present. Tests pass ``device="cpu"``.

**Backend — a deliberate difference from the reference.** The JAX
package's default backend is ``"reference"`` (plain jnp) and its Pallas
kernels are opt-in (``backend="pallas"``). Here the default is ``"cuda"``:
the hand-written ``triangle_mp`` and ``cycle_intersect`` kernels, because
the solve must run them. On CPU tensors their wrappers run the plain
PyTorch versions. ``backend="reference"`` runs the plain versions on any
device; it exists so a run on the card can hold the kernels' solve against
the plain one.

**The registry.** Every entry point dispatches through a bounded LRU
registry keyed, as the reference's, per (mode, config, backend, batched,
batch_shards, kind, traced), and by the resolved state-shard count. An
entry is one resolved callable: config, backend and kernels resolved,
the kernels built at its first call on the card. There is no ``torch.compile`` and no CUDA graph yet (the solve syncs
with the host every round), so a "trace" here is the first call of an
entry at a new input-shape signature: :func:`trace_count` counts those,
which keeps the serving engine's compile budget (≤ buckets × routes ×
ladder rungs) meaningful. A batched entry solves the slots of the leading
axis one after another and stacks the results, so each slot equals the
unbatched solve of that slot bit for bit (the reference's ``vmap`` is
bit-preserving too). Each call records a CUDA event after its work is
queued; :func:`tree_ready` queries it without blocking.

Ported: modes ``p``, ``pd``, ``pd+`` and ``d`` on both separation data
paths (``graph_impl="dense"``, ``"sparse"``, and ``"auto"``, which picks
dense up to ``sparse_threshold`` padded nodes); batches; delta solves,
exact and warm; traces: ``solve(trace=True)``,
``compiled_solve(trace=True)`` and ``Multicut.solve(trace=True)`` return
``(SolveResult, SolveTrace)`` (:mod:`repro_torch.obs.trace`) through their
own registry entry, bit-identical to the untraced solve; delta kinds take
no trace. The edge-range-sharded solve (``state_shards``, the
``pd-state-sharded`` preset; :mod:`repro_torch.core.sharded`): every rank
of the default ``torch.distributed`` group calls :func:`solve` with the
same instance (or its own ``EdgeRange`` from
``make_instance_streamed(state_shards=...)``) and gets the same result;
without a process group the shard count clamps to 1.

**Sharding over cards in one process.** ``separation_shards`` (the
``pd-sharded`` preset) spreads each separation's repulsive-edge batch over
cards, and ``batch_shards`` (:func:`solve_batch`, batched
:func:`compiled_solve`, the serving engine's routes) splits a batch's
leading axis into S contiguous slices, slice r solved slot by slot on
``cuda:r`` (:func:`repro_torch.core.dist.shard_devices`) and the results
stacked back on the batch's device. Both counts are clamped to the cards
present before the registry key is formed, and both are bit-identical to
one shard. The slices run one after another from the host thread.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch

from repro_torch.core import dist as _dist
from repro_torch.core.dist import resolve_batch_shards, \
    resolve_separation_shards, resolve_state_shards
from repro_torch.core.graph import (
    GRAPH_IMPLS, ROW_CAP_FLOOR, MulticutInstance, attractive_degree_p95,
    make_instance, resolve_device, resolve_graph_impl,
)
from repro_torch.core.solver import (
    BACKENDS, MODES, SolveResult, SolverConfig, resolve_intersect,
    resolve_mp, solve_device,
)
from repro_torch.incremental.patch import (
    DeltaPatch, apply_patch_host, make_patch, pad_patch,
)
from repro_torch.incremental.solve import solve_cold_device, \
    solve_delta_device
from repro_torch.incremental.state import DeltaState, init_delta_state
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "BACKENDS", "CACHE_MAXSIZE", "GRAPH_IMPLS", "KINDS", "MODES",
    "DeltaPatch", "DeltaState", "Multicut", "MulticutInstance", "Preset",
    "PRESETS", "SolveResult", "SolverConfig", "apply_patch_host",
    "block_until_ready", "cache_info", "clear_cache", "compiled_delta",
    "compiled_solve", "get_preset", "init_delta_state", "list_presets",
    "make_instance", "make_patch", "pad_patch", "register_preset",
    "set_cache_maxsize", "solve", "solve_batch", "solve_delta",
    "solve_with_state", "stack_instances", "trace_count", "tree_ready",
    "unstack_results",
]

DEFAULT_BACKEND = "cuda"


# ---------------------------------------------------------------------------
# Preset registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Preset:
    """A named (mode, config) pair. Frozen + hashable, like SolverConfig."""
    name: str
    mode: str
    config: SolverConfig
    description: str = ""


PRESETS: dict[str, Preset] = {}


def register_preset(preset: Preset, overwrite: bool = False) -> Preset:
    if preset.mode not in MODES:
        raise ValueError(f"preset {preset.name!r}: unknown mode "
                         f"{preset.mode!r}; expected one of {MODES}")
    if preset.name in PRESETS and not overwrite:
        raise ValueError(f"preset {preset.name!r} already registered")
    PRESETS[preset.name] = preset
    return preset


def get_preset(name: str) -> Preset:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{sorted(PRESETS)}") from None


def list_presets() -> list[str]:
    return sorted(PRESETS)


_PAPER = SolverConfig()
for _p in (
    Preset("paper-p", "p", _PAPER,
           "purely primal contraction (paper's P)"),
    Preset("paper-pd", "pd", _PAPER,
           "interleaved primal-dual, 5-cycles on the original graph"),
    Preset("paper-pd+", "pd+", _PAPER,
           "primal-dual with 5-cycle separation every round"),
    Preset("paper-d", "d", _PAPER,
           "dual-only lower bound (paper's D)"),
    Preset("pd-opt", "pd",
           dataclasses.replace(_PAPER, contract_frac=0.5, max_rounds=40),
           "beyond-paper GAEC-conservative PD (contract_frac=0.5)"),
    Preset("pd-sparse", "pd",
           dataclasses.replace(_PAPER, graph_impl="sparse"),
           "PD pinned to the CSR data path (no (N, N) allocations)"),
    Preset("pd-chunked", "pd",
           dataclasses.replace(_PAPER, graph_impl="sparse",
                               separation_chunk=64),
           "CSR PD with chunked separation: peak separation memory bounded "
           "by separation_chunk, not max_neg (bit-identical results)"),
    Preset("pd-sharded", "pd",
           dataclasses.replace(_PAPER, graph_impl="sparse",
                               separation_chunk=64, separation_shards=4),
           "CSR PD with the repulsive chunk axis spread over up to 4 cards "
           "(clamped to the cards present; bit-identical)"),
    Preset("pd-state-sharded", "pd",
           dataclasses.replace(_PAPER, graph_impl="sparse",
                               first_round_cycles45=False, state_shards=4),
           "fully sharded solve: the whole solver state (CSR included) "
           "edge-range-partitioned over up to 4 ranks of the default "
           "process group for the life of the solve "
           "(repro_torch.core.sharded; 3-cycle separation; clamped to the "
           "ranks present; bit-identical across shard counts)"),
):
    register_preset(_p)


# ---------------------------------------------------------------------------
# The callable registry (what the serving engine dispatches through)
# ---------------------------------------------------------------------------

CACHE_MAXSIZE = 128     # distinct (mode, config, backend, batched, shards,
                        # kind, traced) entries kept live; LRU past that

KINDS = ("solve", "delta", "delta-warm", "delta-open")

_trace_count = [0]      # first calls of an entry at a new input-shape
                        # signature: the port's count of "compilations"

_KERNEL_LIBS = ("triangle_mp", "cycle_intersect")   # the solver's kernels


def trace_count() -> int:
    """First calls of a registry entry at a new input-shape signature
    since process start or the last :func:`clear_cache` /
    :func:`set_cache_maxsize`. A new (mode, config, backend) or a new
    input shape each add one; repeated calls add none."""
    return _trace_count[0]


def _record_ready(tree) -> None:
    """Record one CUDA event after the work that produced ``tree`` was
    queued, and hang it on the tree's CUDA tensors for :func:`tree_ready`
    and :func:`block_until_ready`."""
    cuda = [x for x in tree_leaves(tree) if x.is_cuda]
    if cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(cuda[0].device))
        for x in cuda:
            x._repro_ready = ev


class _Entry:
    """One registry entry: the program of one key with its mode, config
    and backend resolved. Counts a trace at the first call of each input
    signature (shapes, dtypes, devices), when it also builds the kernels
    of a ``"cuda"`` backend on the card. A batched entry solves the
    leading axis slot by slot and stacks the results; with ``shards`` > 1
    it first splits the axis into that many contiguous slices, solves
    slice r on the r-th device of :func:`~repro_torch.core.dist.
    shard_devices` and stacks the slices back on the batch's device."""

    def __init__(self, run, batched: bool, backend: str, shards: int = 1):
        self._run = run
        self._batched = batched
        self._backend = backend
        self._shards = shards
        self._seen: set = set()

    def __call__(self, *args):
        leaves = tree_leaves(args)
        sig = tuple((tuple(x.shape), x.dtype, x.device) for x in leaves)
        if sig not in self._seen:
            if self._backend == "cuda" and any(x.is_cuda for x in leaves):
                from repro_torch.kernels import _build
                _build.build_all(_KERNEL_LIBS)
            self._seen.add(sig)
            _trace_count[0] += 1
        if not self._batched:
            out = self._run(*args)
        else:
            B = leaves[0].shape[0] if leaves and leaves[0].dim() else 0
            if B < 1:
                raise ValueError("a batched call needs a leading batch "
                                 "axis of at least one slot")
            S = self._shards
            if B % S:
                raise ValueError(
                    f"batch size {B} is not divisible by the {S} resolved "
                    f"batch shard(s); pad the batch (see repro_torch.serve."
                    f"pad_batch) or pick a shard count that divides it")
            home, per = leaves[0].device, B // S
            parts = []
            for r, dev in enumerate(_dist.shard_devices(S, home)):
                part = tree_map(
                    lambda x, r=r, dev=dev: x[r * per:(r + 1) * per].to(dev),
                    args)
                outs = [self._run(*tree_map(lambda x, b=b: x[b], part))
                        for b in range(per)]
                parts.append(tree_map(lambda *xs: torch.stack(xs), *outs))
            out = parts[0] if S == 1 else tree_map(
                lambda *xs: torch.cat([x.to(home) for x in xs]), *parts)
        _record_ready(out)
        return out


def _make_registry(maxsize: int):
    """Build the LRU registry. A factory so :func:`set_cache_maxsize` can
    swap the bound in place."""

    @lru_cache(maxsize=maxsize)
    def _compiled(mode: str, cfg: SolverConfig, backend: str, batched: bool,
                  batch_shards: int = 1, kind: str = "solve",
                  traced: bool = False, state_shards: int = 0):
        """One resolved callable per (mode, config, backend, batched,
        batch_shards, kind, traced, resolved state shards: 0 for a
        replicated config). ``kind`` selects the program:
        "solve" takes an instance; "delta-open" takes an instance and
        returns (result, DeltaState); "delta"/"delta-warm" take
        (DeltaState, DeltaPatch) and return (result, DeltaState,
        PatchInfo). ``traced`` selects the telemetry-carrying solve,
        which returns (SolveResult, SolveTrace)."""
        if traced and kind != "solve":
            raise ValueError(f"trace=True applies to kind='solve' "
                             f"callables only (got kind={kind!r})")
        if batch_shards > 1:
            if kind != "solve":
                raise ValueError("batch_shards applies to kind='solve' "
                                 "callables only (delta batches are not "
                                 "sharded)")
            if cfg.separation_shards > 1:
                raise ValueError(
                    "batch_shards and SolverConfig.separation_shards are "
                    "mutually exclusive (one device axis): route large "
                    "instances to separation sharding OR shard the batch "
                    "axis")
        if batched and cfg.state_shards:
            raise ValueError(
                "state_shards and batched solves are mutually exclusive "
                "(one device mesh)")
        mp = resolve_mp(backend)
        intersect = resolve_intersect(backend)
        if kind == "solve":
            def run(inst: MulticutInstance):
                return solve_device(inst, mode=mode, cfg=cfg, mp=mp,
                                    intersect=intersect, trace=traced)
        elif kind == "delta-open":
            def run(inst: MulticutInstance):
                return solve_cold_device(inst, mode, cfg, mp=mp,
                                         intersect=intersect)
        elif kind in ("delta", "delta-warm"):
            warm = kind == "delta-warm"

            def run(state: DeltaState, patch: DeltaPatch):
                return solve_delta_device(state, patch, mode, cfg, mp=mp,
                                          intersect=intersect, warm=warm)
        else:
            raise ValueError(f"unknown executable kind {kind!r}; expected "
                             f"one of {KINDS}")
        return _Entry(run, batched, backend, batch_shards if batched else 1)

    return _compiled


_compiled = _make_registry(CACHE_MAXSIZE)


def set_cache_maxsize(maxsize: int) -> None:
    """Swap the registry for a fresh one bounded at ``maxsize`` and reset
    :func:`trace_count`; every cached entry is dropped."""
    global _compiled
    _compiled = _make_registry(int(maxsize))
    _trace_count[0] = 0


def compiled_solve(mode: str | None = None,
                   config: SolverConfig | None = None,
                   backend: str | None = None,
                   preset: str | Preset | None = None,
                   batched: bool = False, batch_shards: int = 1,
                   trace: bool = False):
    """The cached callable :func:`solve` / :func:`solve_batch` would
    dispatch to. ``batch_shards`` (batched callables only) is clamped to
    the cards present before the key is formed, so both spellings share
    one entry."""
    mode, config, backend = _normalize(mode, config, backend, preset)
    if batch_shards > 1 and not batched:
        raise ValueError("batch_shards applies to batched executables only")
    return _compiled(mode, config, backend, batched,
                     resolve_batch_shards(batch_shards), "solve", trace,
                     _state_key(config))


def compiled_delta(mode: str | None = None,
                   config: SolverConfig | None = None,
                   backend: str | None = None,
                   preset: str | Preset | None = None,
                   warm: bool = False, batched: bool = False):
    """Cached delta callable ``(DeltaState, DeltaPatch) -> (SolveResult,
    DeltaState, PatchInfo)``; every leaf gains a leading batch axis when
    ``batched`` (the serving tier's sticky-session dispatch)."""
    mode, config, backend = _normalize(mode, config, backend, preset)
    if warm and mode == "d":
        raise ValueError("warm delta re-solve needs a primal solution to "
                         "lift; mode 'd' produces none")
    return _compiled(mode, config, backend, batched, 1,
                     "delta-warm" if warm else "delta")


def clear_cache() -> None:
    """Drop every cached entry and reset :func:`trace_count`."""
    _compiled.cache_clear()
    _trace_count[0] = 0


def cache_info():
    """``functools.lru_cache`` statistics of the registry
    (hits/misses/maxsize/currsize)."""
    return _compiled.cache_info()


def tree_ready(tree) -> bool:
    """Non-blocking readiness probe for a tree of tensors: False while the
    CUDA event recorded after the call that produced a CUDA leaf has not
    completed (a leaf made elsewhere gets a fresh event on its stream,
    which answers for everything queued so far). CPU and host leaves are
    always ready. What the serving engine harvests on."""
    for leaf in tree_leaves(tree):
        if leaf.is_cuda:
            ev = getattr(leaf, "_repro_ready", None)
            if ev is None:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(leaf.device))
            if not ev.query():
                return False
    return True


def block_until_ready(tree):
    """Wait until every CUDA leaf of ``tree`` is computed; returns it."""
    for leaf in tree_leaves(tree):
        if leaf.is_cuda:
            ev = getattr(leaf, "_repro_ready", None)
            if ev is not None:
                ev.synchronize()
            else:
                torch.cuda.current_stream(leaf.device).synchronize()
    return tree


def _normalize(mode, config, backend, preset, graph_impl=None):
    if preset is not None:
        p = get_preset(preset) if isinstance(preset, str) else preset
        mode = p.mode if mode is None else mode
        config = p.config if config is None else config
    mode = "pd" if mode is None else mode
    config = SolverConfig() if config is None else config
    if graph_impl is not None:
        if graph_impl not in GRAPH_IMPLS:
            raise ValueError(f"unknown graph_impl {graph_impl!r}; expected "
                             f"one of {GRAPH_IMPLS}")
        config = dataclasses.replace(config, graph_impl=graph_impl)
    if config.separation_shards > 1:
        config = dataclasses.replace(config, separation_shards=(
            resolve_separation_shards(config.separation_shards)))
    backend = DEFAULT_BACKEND if backend is None else backend
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return mode, config, backend


def _state_key(config: SolverConfig) -> int:
    """The registry key's shard count: the resolved ``state_shards`` (it
    depends on the process group at call time), 0 for a replicated
    config."""
    return resolve_state_shards(config.state_shards) \
        if config.state_shards else 0


def solve(inst: MulticutInstance, mode: str | None = None,
          config: SolverConfig | None = None, backend: str | None = None,
          preset: str | Preset | None = None,
          graph_impl: str | None = None,
          tune_sparse_caps: bool = False, trace: bool = False,
          device=None) -> SolveResult:
    """Solve one multicut instance on ``device`` (default ``cuda``; the
    instance is moved there if it lies elsewhere). ``graph_impl`` overrides
    the config's data path; ``tune_sparse_caps=True`` picks
    ``sparse_row_cap_short`` from the instance's p95 attractive degree
    (results are identical for any cap). ``trace=True`` returns
    ``(SolveResult, SolveTrace)`` from its own registry entry: per-round
    telemetry written on the device with no extra host sync, the result
    bit-identical to the untraced solve's; digest it with
    :func:`repro_torch.obs.summarize`."""
    mode, config, backend = _normalize(mode, config, backend, preset,
                                       graph_impl)
    inst = _on(inst, device)
    if tune_sparse_caps and resolve_graph_impl(
            config.graph_impl, inst.num_nodes,
            config.sparse_threshold) == "sparse":
        cap = attractive_degree_p95(inst, ROW_CAP_FLOOR,
                                    config.sparse_row_cap)
        config = dataclasses.replace(config, sparse_row_cap_short=cap)
    return _compiled(mode, config, backend, False, 1, "solve", trace,
                     _state_key(config))(inst)


def _on(tree, device):
    """``tree`` with every tensor on ``device`` (default ``cuda``; raises
    without a card unless told)."""
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev), tree)


def solve_batch(batch: MulticutInstance, mode: str | None = None,
                config: SolverConfig | None = None,
                backend: str | None = None,
                preset: str | Preset | None = None,
                graph_impl: str | None = None, batch_shards: int = 1,
                device=None) -> SolveResult:
    """Solve a stacked batch of same-shape instances (every leaf with a
    leading batch axis, see :func:`stack_instances`) on ``device``; the
    result is batched the same way (see :func:`unstack_results`), each
    slot equal to the unbatched solve of that slot bit for bit.
    ``batch_shards > 1`` splits the batch axis over that many cards
    (clamped to the cards present; the batch size must divide evenly),
    bit-identical to the unsharded solve."""
    mode, config, backend = _normalize(mode, config, backend, preset,
                                       graph_impl)
    batch = _on(batch, device)
    return _compiled(mode, config, backend, True,
                     resolve_batch_shards(batch_shards), "solve", False,
                     _state_key(config))(batch)


def solve_with_state(inst: MulticutInstance, mode: str | None = None,
                     config: SolverConfig | None = None,
                     backend: str | None = None,
                     preset: str | Preset | None = None,
                     graph_impl: str | None = None, device=None,
                     ) -> tuple[SolveResult, DeltaState]:
    """Solve and open a delta session: like :func:`solve`, but also returns
    the :class:`DeltaState` (instance + live CSR + labels) that
    :func:`solve_delta` carries forward. Its CSR feeds this very solve on
    the sparse path, so opening a session costs no extra sort."""
    mode, config, backend = _normalize(mode, config, backend, preset,
                                       graph_impl)
    return _compiled(mode, config, backend, False, 1,
                     "delta-open")(_on(inst, device))


def solve_delta(state: DeltaState, patch: DeltaPatch,
                mode: str | None = None,
                config: SolverConfig | None = None,
                backend: str | None = None,
                preset: str | Preset | None = None,
                graph_impl: str | None = None, warm: bool = False,
                device=None) -> tuple[SolveResult, DeltaState]:
    """One update tick: apply ``patch`` to the carried ``state`` (CSR
    spliced, never rebuilt) and re-solve. Returns ``(result, new_state)``.

    Exact mode (default) equals a cold :func:`solve` of the patched
    instance bit for bit. ``warm=True`` keeps clusters untouched by the
    patch contracted and restricts round-0 separation to the patch
    frontier; its ``lower_bound`` is the carried bound (the last exact
    tick's plus the patch slack ``Σ min(0, Δcost)``), valid but looser,
    and its objective is exact for the returned labels."""
    mode, config, backend = _normalize(mode, config, backend, preset,
                                       graph_impl)
    if warm and mode == "d":
        raise ValueError("warm delta re-solve needs a primal solution to "
                         "lift; mode 'd' produces none")
    kind = "delta-warm" if warm else "delta"
    res, state2, _ = _compiled(mode, config, backend, False, 1, kind)(
        _on(state, device), _on(patch, device))
    return res, state2


def stack_instances(instances: list[MulticutInstance]) -> MulticutInstance:
    """Stack same-shape instances along a new leading batch axis."""
    if not instances:
        raise ValueError("need at least one instance")
    shapes = {(i.num_nodes, i.num_edges) for i in instances}
    if len(shapes) > 1:
        raise ValueError(f"instances must share padded shapes; got {shapes} "
                         "(re-pad with make_instance(pad_nodes=, pad_edges=))")
    return tree_map(lambda *xs: torch.stack(xs), *instances)


def unstack_results(batched: SolveResult) -> list[SolveResult]:
    """Split a batched SolveResult back into per-instance results."""
    B = batched.labels.shape[0]
    return [tree_map(lambda x, b=b: x[b], batched) for b in range(B)]


class Multicut:
    """Solver bound to a (mode, config, backend, device): a thin, stateless
    facade over :func:`solve` / :func:`solve_batch`; two facades with
    equal settings share registry entries."""

    def __init__(self, mode: str = "pd",
                 config: SolverConfig | None = None,
                 backend: str = DEFAULT_BACKEND,
                 graph_impl: str | None = None, device=None):
        self.mode, self.config, self.backend = _normalize(
            mode, config, backend, preset=None, graph_impl=graph_impl)
        self.device = device

    @classmethod
    def from_preset(cls, name: str | Preset, backend: str = DEFAULT_BACKEND,
                    device=None) -> "Multicut":
        p = get_preset(name) if isinstance(name, str) else name
        return cls(mode=p.mode, config=p.config, backend=backend,
                   device=device)

    def replace(self, **kwargs) -> "Multicut":
        """New facade with some settings replaced; config fields (e.g.
        ``mp_iters=8``) are forwarded to ``dataclasses.replace`` on it."""
        cfg_fields = {f.name for f in dataclasses.fields(SolverConfig)}
        cfg_kw = {k: kwargs.pop(k) for k in list(kwargs) if k in cfg_fields}
        new = dict(mode=self.mode, backend=self.backend, device=self.device,
                   config=dataclasses.replace(self.config, **cfg_kw))
        new.update(kwargs)
        return Multicut(**new)

    def solve(self, inst: MulticutInstance, trace: bool = False):
        return solve(inst, mode=self.mode, config=self.config,
                     backend=self.backend, trace=trace, device=self.device)

    def solve_batch(self, batch: MulticutInstance) -> SolveResult:
        return solve_batch(batch, mode=self.mode, config=self.config,
                           backend=self.backend, device=self.device)

    def __repr__(self):
        return (f"Multicut(mode={self.mode!r}, backend={self.backend!r}, "
                f"device={self.device!r}, config={self.config})")
