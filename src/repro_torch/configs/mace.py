"""mace [arXiv:2206.07697]: higher-order E(3)-equivariant message passing.
2 layers, d_hidden=128 channels, l_max=2, correlation order 3, n_rbf=8,
in the Cartesian-irrep formulation (``models/gnn/mace.py``)."""
from repro_torch.configs.base import GNNArch, register
from repro_torch.models.gnn.mace import MACEConfig

CONFIG = MACEConfig(
    name="mace",
    n_layers=2,
    d_hidden=128,
    l_max=2,
    correlation=3,
    n_rbf=8,
)

ARCH = register(GNNArch(id="mace", kind="mace", cfg=CONFIG))
