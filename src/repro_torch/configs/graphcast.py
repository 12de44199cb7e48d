"""graphcast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN.
16 layers, d_hidden=512, mesh refinement 6, sum aggregation, n_vars=227.

The registry's graph-benchmark shapes run the 16-layer GraphNet processor
on the benchmark graphs (processor mode); the native weather
encoder→mesh→decoder path runs in ``repro_torch.examples.weather_graphcast``.
"""
from repro_torch.configs.base import GNNArch, register
from repro_torch.models.gnn.graphcast import GraphCastConfig

CONFIG = GraphCastConfig(
    name="graphcast",
    n_layers=16,
    d_hidden=512,
    mesh_refinement=6,
    n_vars=227,
)

ARCH = register(GNNArch(id="graphcast", kind="graphcast", cfg=CONFIG))
