"""egnn [arXiv:2102.09844]: E(n)-equivariant GNN. 4 layers, d_hidden=64."""
from repro_torch.configs.base import GNNArch, register
from repro_torch.models.gnn.egnn import EGNNConfig

CONFIG = EGNNConfig(name="egnn", n_layers=4, d_hidden=64)

ARCH = register(GNNArch(id="egnn", kind="egnn", cfg=CONFIG))
