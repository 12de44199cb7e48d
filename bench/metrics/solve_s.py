"""solve_s: the window over the whole solves completed in it (the window
closes at the first solve boundary at or after --seconds)."""
from ramabench.readers import solves


def read(run):
    n = solves(run)
    return run.window_s / n if n else None
