"""Production and debug meshes over the current process group (port of
``repro.launch.mesh``): ``torch.distributed.device_mesh.DeviceMesh``
objects in place of ``jax.make_mesh``.

Single pod:  (data=16, model=16)          — 256 ranks
Multi-pod:   (pod=2, data=16, model=16)   — 512 ranks; the pod axis
             carries pure data parallelism, model parallelism never
             crosses pods.

Each function builds its mesh over the default process group, which must
exist and hold exactly the mesh's ranks: real ranks (NCCL or gloo), or
the ``fake`` backend (``torch.testing._internal.distributed.fake_pg``),
which traces a pod's mesh from one process. Importing this module
touches no process group. A mesh holds its per-axis subgroups: drop it
before the default group is destroyed
(``repro_torch.launch.ranks.process_group`` checks that none survives).
"""
from __future__ import annotations

import math

import torch.distributed as dist

__all__ = ["data_axes", "make_debug_mesh", "make_production_mesh",
           "model_axis"]


def _mesh(shape: tuple, axes: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of "
                           f"{math.prod(shape)} ranks; none is initialised")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh {axes} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The (data=16, model=16) pod mesh, or (pod=2, data=16, model=16)
    across two pods, over a default group of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, device_type="cuda"):
    """A small (data, model) mesh for tests and examples; the default
    group must have ``n_data * n_model`` ranks."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def data_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
