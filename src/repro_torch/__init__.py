"""PyTorch/CUDA port of the RAMA multicut solver (``repro`` is the JAX
reference). The main path is :func:`repro_torch.api.solve` with the
default ``pd`` preset on the sparse CSR data path; its two hot kernels
(``triangle_mp`` and ``cycle_intersect``) are hand-written CUDA C++ for
Hopper, built at first use (``repro_torch.kernels._build``).

Importing this package imports ``torch`` and numpy only — never ``jax``
and never the ``repro`` package.
"""
