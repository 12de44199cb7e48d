"""Roofline accounting of the port on one card: peaks and terms
(:mod:`.analysis`) and the per-phase profile of a solver round
(:mod:`.solver`)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    FP32_FLOPS, HW, TF32_FLOPS, Hardware, dominant_term, roofline_fraction,
    roofline_terms, step_time_estimate,
)
from repro_torch.roofline.solver import (  # noqa: F401
    PHASES, WorkCounter, count_work, loop_corrected, profile_solve_round,
)
