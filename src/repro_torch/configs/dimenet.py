"""dimenet [arXiv:2003.03123]: directional message passing GNN.
6 blocks, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6."""
from repro_torch.configs.base import GNNArch, register
from repro_torch.models.gnn.dimenet import DimeNetConfig

CONFIG = DimeNetConfig(
    name="dimenet",
    n_blocks=6,
    d_hidden=128,
    n_bilinear=8,
    n_spherical=7,
    n_radial=6,
)

ARCH = register(GNNArch(id="dimenet", kind="dimenet", cfg=CONFIG))
