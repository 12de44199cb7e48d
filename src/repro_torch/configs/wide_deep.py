"""wide-deep [arXiv:1606.07792]: 40 sparse fields, embed_dim=32,
MLP 1024-512-256, concat interaction. Embedding tables of 10^6 rows per
field (5.12 GB of float32 on one card)."""
from repro_torch.configs.base import RecsysArch, register
from repro_torch.models.recsys import WideDeepConfig

CONFIG = WideDeepConfig(
    name="wide-deep",
    n_sparse=40,
    n_dense=13,
    embed_dim=32,
    vocab_per_field=1_000_000,
    mlp_dims=(1024, 512, 256),
)

ARCH = register(RecsysArch(id="wide-deep", cfg=CONFIG))
