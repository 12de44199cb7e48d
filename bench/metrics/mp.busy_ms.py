"""mp.busy_ms: device time of what was launched inside the
repro.message_passing ranges, per solve of the traced window."""
from ramabench.readers import phase_ms_per_solve


def read(run):
    return phase_ms_per_solve(run, "repro.message_passing", "busy_s")
