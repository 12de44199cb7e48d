"""contraction.forest_discarded_ms: the CUDA-event span of the
contraction.forest spans in the rounds whose contraction set was the
matching's (the forest computed and thrown away), per solve of the
traced window."""
from ramabench.program_spans import device_ms_per_solve, window


def read(run):
    w = window(run)
    forest = w.named("contraction.forest") if w is not None else []
    if device_ms_per_solve(w, forest) is None:
        return None
    return sum(s.args["device_ms"] for s in forest
               if not s.args["used"]) / w.solves
