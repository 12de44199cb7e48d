"""PyTorch/CUDA port of the RAMA system (``repro`` is the JAX reference).
Two paths run on the card so far:

* the multicut solve, :func:`repro_torch.api.solve` with the default
  ``pd`` preset on the sparse CSR data path, through the hand kernels
  ``triangle_mp`` and ``cycle_intersect``;
* dense LM serving (:mod:`repro_torch.models.transformer`,
  :mod:`repro_torch.configs`, :mod:`repro_torch.launch.serve`), whose
  prefill runs the hand kernel ``flash_attention``.

The kernels are hand-written CUDA C++ for Hopper, built at first use
(``repro_torch.kernels._build``).

Importing this package imports ``torch`` and numpy only — never ``jax``
and never the ``repro`` package.
"""
