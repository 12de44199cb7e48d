"""Synthetic data pipelines of the port (the JAX package's ``data/``)."""
