from repro_torch.kernels.flash_attention.chunked import (
    chunked_attention, chunked_attention_vjp,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_trainable,
)
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     decode_attention_ref)

__all__ = ["attention_ref", "chunked_attention", "chunked_attention_vjp",
           "decode_attention_ref", "flash_attention",
           "flash_attention_trainable"]
