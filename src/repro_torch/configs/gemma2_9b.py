"""gemma2-9b [arXiv:2408.00118; hf]: dense, local+global alternating
attention, logit softcaps. 42L, d_model=3584, 16H GQA kv=8, d_ff=14336,
vocab=256000, local window 4096."""
import torch

from repro_torch.configs.base import LMArch, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma2-9b",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    local_global_alternate=True,
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    use_flash=True,
    act_sharding=(("pod", "data"), None, "model"),
)

ARCH = register(LMArch(id="gemma2-9b", cfg=CONFIG, grad_accum=8))
