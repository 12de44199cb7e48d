from repro_torch.kernels.contract_matmul.ops import contract_matmul, matmul
from repro_torch.kernels.contract_matmul.ref import (
    contract_matmul_ref, matmul_ref, one_hot,
)

__all__ = ["contract_matmul", "matmul", "contract_matmul_ref", "matmul_ref",
           "one_hot"]
