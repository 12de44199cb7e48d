"""The check that a run loaded neither JAX nor the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: ``repro_torch`` and ``repro_torch.api`` pass, ``repro``
and ``repro.core`` do not.
"""
from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(module_names) -> list[str]:
    """The names among ``module_names`` whose top-level name is
    forbidden, sorted."""
    return sorted(n for n in module_names
                  if n.split(".", 1)[0] in FORBIDDEN)
