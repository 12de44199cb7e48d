"""Multicut solver API of the PyTorch/CUDA port (mirrors ``repro.api``).

    from repro_torch import api
    from repro_torch.core.graph import grid_instance

    inst = grid_instance(512, 1024)           # on cuda by default
    res = api.solve(inst)                     # paper PD, hand kernels
    res = api.solve(inst, preset="pd-chunked")
    mc = api.Multicut.from_preset("paper-pd+")
    res = mc.solve(inst)

**Device.** Entry points run on the card: ``make_instance``/the
generators and :func:`solve` put tensors on ``cuda`` unless ``device=`` names
another device, and raise when no card is present. Tests pass
``device="cpu"``.

**Backend — a deliberate difference from the reference.** The JAX
package's default backend is ``"reference"`` (plain jnp) and its Pallas
kernels are opt-in (``backend="pallas"``). Here the default is ``"cuda"``:
the hand-written ``triangle_mp`` and ``cycle_intersect`` kernels, because
the solve must run them. On CPU tensors their wrappers run the plain
PyTorch versions. ``backend="reference"`` runs the plain versions on any
device; it exists so a run on the card can hold the kernels' solve against
the plain one.

Ported so far: modes ``p``, ``pd``, ``pd+`` and ``d`` on both separation
data paths (``graph_impl="dense"``, ``"sparse"``, and ``"auto"``, which
picks dense up to ``sparse_threshold`` padded nodes). Traces
(``trace=True``), ``state_shards`` and ``separation_shards > 1`` raise
``NotImplementedError`` naming their ROADMAP item; batches and the
executable cache are not ported yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.graph import (
    GRAPH_IMPLS, ROW_CAP_FLOOR, MulticutInstance, attractive_degree_p95,
    make_instance, resolve_device, resolve_graph_impl,
)
from repro_torch.core.solver import (
    BACKENDS, MODES, SolveResult, SolverConfig, resolve_intersect,
    resolve_sweep, solve_device,
)

__all__ = [
    "BACKENDS", "GRAPH_IMPLS", "MODES", "Multicut", "MulticutInstance",
    "Preset", "PRESETS", "SolveResult", "SolverConfig", "get_preset",
    "list_presets", "make_instance", "register_preset", "solve",
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
):
    register_preset(_p)


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
    backend = DEFAULT_BACKEND if backend is None else backend
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return mode, config, backend


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
    (results are identical for any cap)."""
    mode, config, backend = _normalize(mode, config, backend, preset,
                                       graph_impl)
    dev = resolve_device(device)
    if inst.device != dev:
        inst = inst.to(dev)
    if tune_sparse_caps and resolve_graph_impl(
            config.graph_impl, inst.num_nodes,
            config.sparse_threshold) == "sparse":
        cap = attractive_degree_p95(inst, ROW_CAP_FLOOR,
                                    config.sparse_row_cap)
        config = dataclasses.replace(config, sparse_row_cap_short=cap)
    return solve_device(inst, mode=mode, cfg=config,
                        sweep=resolve_sweep(backend),
                        intersect=resolve_intersect(backend), trace=trace)


class Multicut:
    """Solver bound to a (mode, config, backend, device): a thin, stateless
    facade over :func:`solve`."""

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

    def solve(self, inst: MulticutInstance) -> SolveResult:
        return solve(inst, mode=self.mode, config=self.config,
                     backend=self.backend, device=self.device)

    def __repr__(self):
        return (f"Multicut(mode={self.mode!r}, backend={self.backend!r}, "
                f"device={self.device!r}, config={self.config})")
