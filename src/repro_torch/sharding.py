"""Sharding plans as DTensor placements (the port's counterpart of JAX's
``PartitionSpec``, ``NamedSharding`` and ``with_sharding_constraint``).

A plan names, for each dimension of a tensor, the mesh axes that split it
(:class:`P`, entry for entry the reference's ``PartitionSpec``: ``None``,
an axis name, or a tuple of axis names, major to minor). Over a
``torch.distributed.device_mesh.DeviceMesh`` with named axes
(``repro_torch.launch.mesh``), :func:`placements` turns it into the
DTensor placement list, one entry per mesh axis:
``P(None, ("pod", "data"), "model")`` on a (pod, data, model) mesh is
``[Shard(1), Shard(1), Shard(2)]``, and the local shard is the one
``jax.sharding.NamedSharding`` gives for the same global shape.

XLA refuses a plan whose axes do not divide a dimension of an argument;
DTensor would shard it unevenly without a word. :func:`placements`
raises instead, so no plan hands out uneven shards.

Plain tensors pass through every helper here untouched (one card, no
mesh): a model that calls :func:`constrain` computes the same bits
without a mesh as before it made the call.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

__all__ = ["P", "Sharding", "axis_sizes", "clear_dtensor_caches",
           "constrain", "distribute", "dp_axes", "filter_axes",
           "grad_placements", "is_dtensor", "local_bytes", "local_offset",
           "local_shape", "map_specs", "named", "pin", "placements",
           "prod_axes", "run_local"]


class P(tuple):
    """A per-dimension spec of mesh-axis names (``jax.sharding.
    PartitionSpec``): ``P(None, "model")``, ``P(("pod", "data"), None)``.
    Entries past the last are unsharded."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            tuple(p) if isinstance(p, list) else p for p in parts))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


class Sharding(NamedTuple):
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of any mesh object with
    ``axis_names`` and a ``shape`` dict, as the reference's)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return {n: mesh.shape[n] for n in mesh.axis_names}


def dp_axes(mesh) -> tuple:
    """The data-parallel axes present in this mesh (the reference's
    ``_dp``)."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def prod_axes(mesh, axes) -> int:
    """Product of the sizes of ``axes`` (1 for none; the reference's
    ``_prod``)."""
    sizes = axis_sizes(mesh)
    return max(math.prod(sizes[a] for a in axes), 1)


def map_specs(fn, tree):
    """``fn`` applied to every :class:`P` of a tree of dicts, lists and
    tuples (a spec is a leaf, though it is a tuple)."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not isinstance(tree, Sharding):
        return type(tree)(*(map_specs(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return fn(tree)


def named(mesh, tree):
    """Every spec of ``tree`` on ``mesh`` (the reference's ``_ns``)."""
    return map_specs(lambda s: Sharding(mesh, s), tree)


def filter_axes(mesh, tree):
    """Drop axis names not present in this mesh (pod on a single pod; the
    reference's ``_filter_axes``)."""
    names = set(axis_sizes(mesh))

    def fix(spec):
        parts = []
        for p in spec:
            if isinstance(p, tuple):
                kept = tuple(a for a in p if a in names)
                parts.append(kept if kept else None)
            else:
                parts.append(p if p is None or p in names else None)
        return P(*parts)

    return map_specs(fix, tree)


def _axes_of(part) -> tuple:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def placements(mesh, spec, shape=None) -> list:
    """The DTensor placement list (one entry per mesh axis) of ``spec``.
    Raises on an axis the mesh lacks, an axis used twice, axes of one
    dimension out of mesh order (DTensor shards in mesh order), and,
    given the global ``shape``, a dimension the axes do not divide. An
    axis of size one is Replicate (it splits nothing)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = axis_sizes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    used = set()
    if shape is not None and len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{len(shape)} dims of {tuple(shape)}")
    for dim, part in enumerate(spec):
        axes = _axes_of(part)
        missing = [a for a in axes if a not in sizes]
        if missing:
            raise ValueError(f"spec {spec}: mesh {names} has no axis "
                             f"{missing}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are "
                             f"not in mesh order {names}")
        n = math.prod(sizes[a] for a in axes)
        if shape is not None and shape[dim] % n:
            raise ValueError(f"spec {spec}: dim {dim} of {tuple(shape)} "
                             f"({shape[dim]}) does not divide over axes "
                             f"{axes} ({n} shards)")
        for i in idx:
            if isinstance(out[i], Shard) or i in used:
                raise ValueError(f"spec {spec}: axis {names[i]} used "
                                 f"twice")
            used.add(i)
            if sizes[names[i]] > 1:     # an axis of one splits nothing
                out[i] = Shard(dim)
    return out


def local_shape(mesh, spec, shape) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor under
    ``spec`` (the same on every rank: shards are even)."""
    sizes = axis_sizes(mesh)
    placements(mesh, spec, shape)          # validates
    out = list(shape)
    for dim, part in enumerate(spec):
        out[dim] //= math.prod(sizes[a] for a in _axes_of(part))
    return tuple(out)


def local_offset(mesh, pl, shape) -> tuple:
    """This rank's offset into the global ``shape`` under placements
    ``pl`` (even shards; the mesh axes of one dimension split it major to
    minor in mesh order)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    idx = [0] * len(shape)
    parts = [1] * len(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(i)
            idx[p.dim] = idx[p.dim] * n + coord[i]
            parts[p.dim] *= n
    return tuple(k * (s // n) for k, s, n in zip(idx, shape, parts))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def distribute(x: torch.Tensor, sharding: Sharding):
    """A DTensor of ``sharding`` whose global value is ``x``: each rank
    keeps its own slice (no collective)."""
    from torch.distributed.tensor import DTensor
    mesh, spec = sharding
    pl = placements(mesh, spec, x.shape)
    local = x
    off = local_offset(mesh, pl, x.shape)
    for dim, n in enumerate(local_shape(mesh, spec, x.shape)):
        if n != x.shape[dim]:
            local = local.narrow(dim, off[dim], n)
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of tensors and DTensors."""
    from repro_torch.tree import tree_leaves
    total = 0
    for t in tree_leaves(tree):
        loc = t.to_local() if is_dtensor(t) else t
        total += loc.numel() * loc.element_size()
    return total


def constrain(x, spec):
    """``jax.lax.with_sharding_constraint``: a DTensor redistributed to
    ``spec`` on its own mesh (axes the mesh lacks dropped; a dimension
    the remaining axes do not divide keeps the longest prefix of them
    that does, XLA's padding having no DTensor counterpart); a plain
    tensor unchanged."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    parts = []
    for dim, part in enumerate(spec):
        axes = tuple(a for a in _axes_of(part) if a in sizes)
        while axes and x.shape[dim] % math.prod(sizes[a] for a in axes):
            axes = axes[:-1]
        parts.append(axes or None)
    pl = placements(mesh, P(*parts), x.shape)
    if list(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def grad_placements(in_pl, out_pls) -> list:
    """The gradient placements of a ``local_map`` input: Partial on every
    mesh axis where the input is replicated but an output is not (each
    rank's local function saw only its own part of the work, so its
    gradient is a partial sum), else the input's own."""
    from torch.distributed.tensor import Partial, Replicate
    out = []
    for i, p in enumerate(in_pl):
        split = any(not isinstance(o[i], Replicate) for o in out_pls)
        out.append(Partial() if isinstance(p, Replicate) and split else p)
    return out


def run_local(fn, args, in_pls, out_pls, mesh):
    """``fn`` on each rank's local shards (``torch.distributed.tensor.
    experimental.local_map``): DTensor ``args`` are first redistributed to
    ``in_pls`` (None for a non-tensor argument), the outputs wrapped with
    ``out_pls`` (one placement list, or a tuple of them for a tuple of
    outputs). Each input's gradient placements follow
    :func:`grad_placements`."""
    from torch.distributed.tensor.experimental import local_map
    outs = [out_pls] if not isinstance(out_pls, tuple) else list(out_pls)
    grads = tuple(None if p is None else grad_placements(p, outs)
                  for p in in_pls)
    return local_map(fn, out_placements=out_pls, in_placements=tuple(in_pls),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def pin(x):
    """``x`` unchanged, but in backward its gradient is first brought to
    x's placements (a redistribute to where x already is: its backward
    always redistributes), so the op that made x sees its gradient where
    its output was. A plain tensor unchanged."""
    return x.redistribute(x.device_mesh, x.placements) if is_dtensor(x) \
        else x


def clear_dtensor_caches() -> None:
    """Drop DTensor's cached sharding decisions, which hold the meshes
    (and so the process groups) they were made on: call before a group
    is destroyed (``repro_torch.launch.ranks.process_group`` checks that
    none survives)."""
    import functools
    from torch.distributed.tensor import DTensor, _collective_utils, \
        _redistribute
    from torch.distributed.tensor._ops import single_dim_strategy

    def clear(obj):
        for name in dir(obj):
            fn = getattr(obj, name, None)
            if isinstance(fn, functools._lru_cache_wrapper):
                fn.cache_clear()
            elif hasattr(getattr(fn, "cache", None), "cache_clear"):
                fn.cache.cache_clear()      # DTensor's thread-local caches

    torch._C._clear_DTensor_sharding_propagator_cache()  # the C++ ones
    clear(DTensor._op_dispatcher.sharding_propagator)
    clear(_redistribute)
    _redistribute.clear_redistribute_planner_cache()
    clear(single_dim_strategy)
    _collective_utils.MeshTopoInfo.build_from_mesh.cache_clear()
