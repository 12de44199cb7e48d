"""device.idle_pct.solve: 100 * (1 - busy / window) over the traced window
of a solve cell; busy is the union of the device's kernel, copy and set
intervals in the profiler's trace."""
from ramabench.readers import idle_pct


def read(run):
    return idle_pct(run)
