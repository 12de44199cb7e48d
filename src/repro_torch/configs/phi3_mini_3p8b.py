"""phi3-mini-3.8b [arXiv:2404.14219]: dense RoPE/SwiGLU.
32L, d_model=3072, 32H (kv=32 — full MHA), d_ff=8192, vocab=32064."""
import torch

from repro_torch.configs.base import LMArch, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="phi3-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    use_flash=True,
    act_sharding=(("pod", "data"), None, "model"),
)

ARCH = register(LMArch(id="phi3-mini-3.8b", cfg=CONFIG))
