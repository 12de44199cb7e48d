"""The reader of ``metrics/contraction.forest_run_pct`` on hand-built
spans: 100 x the window's ``contraction.forest`` spans over the
``forest_gate`` syncs its solves counted; nothing where the program
records no gate count, the recorder dropped spans or the run was not
traced. Then one traced run of the cell's harness on the CPU, at a 12x16
image."""
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from ramabench import harness, manifest  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import phases  # noqa: E402
from repro_torch.obs.spans import Span  # noqa: E402

MAN = manifest.Manifest()
NAME = "contraction.forest_run_pct"
GATE = "solver_syncs_total.forest_gate"


def read(run):
    return manifest.reader(NAME)(run)


def fake_run(n_records, traced=True):
    run = harness.Run(cell={}, config={}, plan=None, traced=traced)
    run.records = [{"host": {}} for _ in range(n_records)]
    run.trace = {} if traced else None
    return run


class SpanMaker:
    """Spans appended to the program's recorder as its phases would."""

    def __init__(self):
        self.rec = obs.solver_spans()
        self.rec.clear()
        self.tid = 0

    def add(self, name, parent, **args):
        self.rec.append(Span(name, "solver", 0.0, 0.0, self.tid,
                             dict(args, parent=parent)))
        return len(self.rec) - 1

    def solve(self, forests, gates):
        """One solve: ``forests`` says for each round whether its forest
        ran; ``gates`` is the solve's count of forest_gate syncs (None: a
        program without the gate)."""
        self.tid += 1
        counters = {"solver_syncs_total.cc_check": 7}
        if gates is not None:
            counters[GATE] = gates
        s = self.add("solve", None, counters=counters)
        for r, ran in enumerate(forests):
            rd = self.add("round", s, r=r, slots=10, live_edges=10)
            c = self.add("contraction", rd, r=r)
            if ran:
                self.add("contraction.forest", c, r=r, used=False,
                         device_ms=1.0)


@pytest.fixture
def spans():
    b = SpanMaker()
    yield b
    b.rec.clear()


def test_forest_run_share_is_forest_spans_over_gates(spans):
    spans.solve([True, True], 2)       # an earlier run: never read
    # the window: one forest in four choices, then none in three
    spans.solve([False, True, False, False], 4)
    spans.solve([False, False, False], 3)
    assert read(fake_run(2)) == pytest.approx(100.0 * 1 / 7)
    # a run whose every round took the matching at the gate
    assert read(fake_run(1)) == 0.0
    assert read(fake_run(2, traced=False)) is None
    spans.rec.n_dropped = 1
    assert read(fake_run(2)) is None


def test_forest_run_share_needs_the_gate(spans):
    # a forest every round but no forest_gate count: a program that runs
    # the forest ungated reports nothing
    spans.solve([True, True], None)
    spans.solve([True], None)
    assert read(fake_run(2)) is None


def test_forest_run_share_in_a_traced_run_on_the_cpu(monkeypatch):
    cell = MAN.cell("cityscapes.pd")
    config, traffic = MAN.config(cell), manifest.traffic(cell["traffic"])
    config["instance"].update(h=12, w=16)
    traffic["count"] = 1
    obs.solver_spans().clear()
    # count the CPU's reads as a card's syncs, so the sites show here
    monkeypatch.setattr(phases, "SYNC_DEVICES", ("cuda", "cpu"))
    result, _, run = harness.run_cell(
        cell, config, traffic, manifest.limits(cell["name"]), 2**31 + 13,
        0.0, True, torch.device("cpu"), time.perf_counter(),
        MAN.metrics(cell, True))
    assert result["correct"]
    spans = obs.solver_spans().spans
    solves = [s for s in spans if s.name == "solve"]
    assert len(solves) == len(run.records) == 1   # the window's solve only
    gates = solves[0].args["counters"][GATE]
    forests = sum(s.name == "contraction.forest" for s in spans)
    assert gates > 0
    assert result["metrics"][NAME]["value"] == pytest.approx(
        100.0 * forests / gates)
