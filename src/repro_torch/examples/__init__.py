"""Examples of the port, run as modules of the package:
``python -m repro_torch.examples.gnn_multicut`` and
``python -m repro_torch.examples.weather_graphcast`` (each takes
``--device``, default ``cuda``, and ``--steps``)."""
