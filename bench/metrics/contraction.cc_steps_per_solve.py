"""contraction.cc_steps_per_solve: connected-components steps per solve of
the traced window, each step two min-scatters over every padded edge
slot; the program's own count on its contraction.cc spans."""
from ramabench.program_spans import window


def read(run):
    w = window(run)
    cc = w.named("contraction.cc") if w is not None else []
    if not cc:
        return None
    return sum(s.args["steps"] for s in cc) / w.solves
