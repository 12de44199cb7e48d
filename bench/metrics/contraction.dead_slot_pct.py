"""contraction.dead_slot_pct: 100 * (slots - live edges) / slots over the
rounds of the traced window that contract: the padded edge slots that
every scatter of contraction still runs over, though no live edge holds
them (the round span's slots and its live edges entering the round)."""
from ramabench.program_spans import window


def read(run):
    w = window(run)
    rounds = [w.parent(s) for s in w.named("contraction")] \
        if w is not None else []
    slots = sum(r.args["slots"] for r in rounds)
    if not slots:
        return None
    live = sum(r.args["live_edges"] for r in rounds)
    return 100.0 * (slots - live) / slots
