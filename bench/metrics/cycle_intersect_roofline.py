"""cycle_intersect_roofline: the least time each launch's inputs need
(ramabench.work.cycle_intersect against the INT32 and HBM peaks) as a
share of the device time of the cycle_intersect kernel."""
from ramabench.readers import cycle_intersect_min_seconds, kernel_seconds, \
    roofline_pct

SYMBOLS = ("cycle_intersect_kernel",)


def read(run):
    if run.trace is None or not run.capture.intersect_calls:
        return None
    return roofline_pct(cycle_intersect_min_seconds(run),
                        kernel_seconds(run, SYMBOLS))
