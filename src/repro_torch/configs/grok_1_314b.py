"""grok-1-314b [hf:xai-org/grok-1]: MoE 8 experts top-2.
64L, d_model=6144, 48H GQA kv=8, d_ff=32768 per expert, vocab=131072.

Memory posture (as the JAX config): params AND Adam moments in bf16
(6 bytes a param), the documented trade-off for this arch at 314B
params.
"""
import torch

from repro_torch.configs.base import LMArch, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    moe=True,
    n_experts=8,
    top_k=2,
    capacity_factor=1.25,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    param_dtype=torch.bfloat16,
    remat=True,
    use_flash=True,
    act_sharding=(("pod", "data"), None, "model"),
)

ARCH = register(LMArch(id="grok-1-314b", cfg=CONFIG,
                       opt_state_dtype=torch.bfloat16, grad_accum=8))
