"""triangle_mp_roofline: the least time each mp_phase call's inputs need
(ramabench.work.triangle_mp_phase against the FP32 and HBM peaks) as a
share of the device time of the triangle_mp kernels."""
from ramabench.readers import kernel_seconds, roofline_pct, \
    triangle_mp_min_seconds

SYMBOLS = ("triangle_mp_phase_kernel", "triangle_mp_pass_kernel",
           "triangle_mp_land_kernel")


def read(run):
    if run.trace is None or not run.capture.mp_calls:
        return None
    return roofline_pct(triangle_mp_min_seconds(run),
                        kernel_seconds(run, SYMBOLS))
