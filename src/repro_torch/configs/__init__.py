"""Configs of the port: the LM configs (dense and MoE), the GNN configs
(dimenet, egnn, mace, graphcast), the wide-deep recommender and the RAMA
multicut config. Importing this package registers each in
:data:`repro_torch.configs.base.REGISTRY` (selectable by id)."""
from repro_torch.configs import (  # noqa: F401
    dimenet,
    egnn,
    gemma2_9b,
    granite_34b,
    graphcast,
    grok_1_314b,
    llama4_scout_17b_a16e,
    mace,
    phi3_mini_3p8b,
    rama_multicut,
    wide_deep,
)
from repro_torch.configs.base import REGISTRY, get_arch  # noqa: F401
