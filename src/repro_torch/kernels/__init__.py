"""Hand-written Hopper kernels of the port. Each kernel package holds a
``ref.py`` (the plain PyTorch version) and an ``ops.py`` (the wrapper: it
launches the CUDA kernel for a CUDA tensor, runs the plain version for a
CPU tensor, and counts its launches). Sources live in ``repro_torch/csrc``
and are built at first use by :mod:`repro_torch.kernels._build`."""
