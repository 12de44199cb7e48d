"""Configs of the port: the dense LM configs and the RAMA multicut config.
Importing this package registers each in
:data:`repro_torch.configs.base.REGISTRY` (selectable by id). The MoE LM
configs, GNN and recsys configs are not ported yet."""
from repro_torch.configs import (  # noqa: F401
    gemma2_9b,
    granite_34b,
    phi3_mini_3p8b,
    rama_multicut,
)
from repro_torch.configs.base import REGISTRY, get_arch  # noqa: F401
