"""pd_gap_pct: 100 * sum(objective - lower bound) / sum(|trivial bound|)
over every solve of the window: the objective as the reference recounts
it from the answer's labels, the bound as the program reports it, and
the trivial bound sum_e min(0, c_e) of each instance, which no change to
the program can move. A higher objective and a weaker bound both raise
it."""


def read(run):
    done = [r for r in run.done_in_window if r.get("recount") is not None]
    den = sum(abs(r["trivial"]) for r in done)
    if not done or den == 0:
        return None
    gap = sum(r["recount"] - r["host"]["lower_bound"] for r in done)
    return 100.0 * gap / den
