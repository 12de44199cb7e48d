"""loop.program_syncs_per_solve: host syncs per solve of the traced
window, counted by the program where each happens (the change of its
solver_syncs_total counters that each solve span carries, summed over
the sites)."""
from ramabench.program_spans import window

PREFIX = "solver_syncs_total"


def read(run):
    w = window(run)
    if w is None:
        return None
    solves = w.named("solve")
    return sum(n for s in solves for k, n in s.args["counters"].items()
               if k.split(".")[0] == PREFIX) / w.solves
