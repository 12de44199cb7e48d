"""contraction_roofline: the bytes that each contraction call's live edges
and nodes need (ramabench.work.contraction) over the HBM bandwidth, as a
share of the device time launched inside the repro.contraction ranges."""
from ramabench.readers import contraction_min_seconds, roofline_pct


def read(run):
    if run.trace is None or not run.capture.contractions:
        return None
    busy = run.trace["phases"].get("repro.contraction", {}).get("busy_s", 0)
    return roofline_pct(contraction_min_seconds(run), busy)
