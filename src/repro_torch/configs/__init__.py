"""Configs of the port: the LM configs (dense and MoE) and the RAMA
multicut config. Importing this package registers each in
:data:`repro_torch.configs.base.REGISTRY` (selectable by id). The GNN and
recsys configs are not ported yet (ROADMAP Queue 1 item 15.4)."""
from repro_torch.configs import (  # noqa: F401
    gemma2_9b,
    granite_34b,
    grok_1_314b,
    llama4_scout_17b_a16e,
    phi3_mini_3p8b,
    rama_multicut,
)
from repro_torch.configs.base import REGISTRY, get_arch  # noqa: F401
