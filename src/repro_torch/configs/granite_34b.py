"""granite-34b [arXiv:2405.04324; hf]: dense llama-arch code model.
88L, d_model=6144, 48 heads, GQA kv=1 (MQA), d_ff=24576, vocab=49152."""
import torch

from repro_torch.configs.base import LMArch, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="granite-34b",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    use_flash=True,
    act_sharding=(("pod", "data"), None, "model"),
)

ARCH = register(LMArch(id="granite-34b", cfg=CONFIG, grad_accum=16))
