"""The benchmark of the PyTorch and CUDA port of RAMA (``repro_torch``).

``bench/run.py`` runs one cell of ``BENCHMARK.json`` once. This package
holds the yardstick that later changes to the program may not edit: the
instance generator, the traffic generator, the wrappers that observe the
port's entry functions, the frozen operation and byte counts, the
reduction of a profiler trace, and the judge. The plain reference that
decides ``correct`` lives beside it, in ``bench/reference/``.
"""
