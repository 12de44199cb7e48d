"""Sorted-row intersection for conflicted-cycle separation (RAMA §3.2.2):
``intersect_rows(ci, cj) -> pos``. See ops.py for the wrapper, ref.py for
the plain PyTorch version, csrc/cycle_intersect.cu for the kernel."""
from repro_torch.kernels.cycle_intersect.ops import intersect_rows
from repro_torch.kernels.cycle_intersect.ref import intersect_rows_ref

__all__ = ["intersect_rows", "intersect_rows_ref"]
