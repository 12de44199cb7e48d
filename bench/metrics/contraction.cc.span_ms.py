"""contraction.cc.span_ms: the stream's time from the first to the last
CUDA event of each contraction.cc span (one connected_components call),
summed per solve of the traced window: a span, so idle time inside it
counts."""
from ramabench.program_spans import device_ms_per_solve, window


def read(run):
    w = window(run)
    return None if w is None else \
        device_ms_per_solve(w, w.named("contraction.cc"))
