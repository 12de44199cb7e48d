"""Examples of the port, run as modules of the package, each with
``--device`` (default ``cuda``): ``python -m repro_torch.examples.<name>``
for ``quickstart``, ``image_segmentation``, ``serve_tiles``,
``distributed_multicut`` (``--world 1|2|4|8``), ``gnn_multicut`` and
``weather_graphcast`` (these two take ``--steps``)."""
