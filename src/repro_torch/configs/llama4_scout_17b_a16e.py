"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E]: MoE,
16 experts top-1. 48L, d_model=5120, 40H GQA kv=8, d_ff=8192 per expert,
vocab=202048. (Early-fusion multimodality is out of scope here: the LM
backbone only.)"""
import torch

from repro_torch.configs.base import LMArch, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=True,
    n_experts=16,
    top_k=1,
    capacity_factor=1.25,
    rope_theta=500000.0,
    dtype=torch.bfloat16,
    remat=True,
    use_flash=True,
    act_sharding=(("pod", "data"), None, "model"),
)

ARCH = register(LMArch(id="llama4-scout-17b-a16e", cfg=CONFIG,
                       grad_accum=16))
