"""contraction.forest_run_pct: the share of the traced window's
contraction-set choices that ran the spanning forest: 100 x the
contraction.forest spans over the forest_gate host syncs that the solve
spans counted (one a choice, where the program reads the matching's size
before it runs the forest). Nothing from a program without that gate."""
from ramabench.program_spans import window

GATE = "solver_syncs_total.forest_gate"


def read(run):
    w = window(run)
    if w is None:
        return None
    gates = sum(s.args.get("counters", {}).get(GATE, 0)
                for s in w.named("solve"))
    if not gates:
        return None
    return 100.0 * len(w.named("contraction.forest")) / gates
