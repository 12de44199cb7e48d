"""The readers of the metrics the program records itself
(``ramabench.program_spans`` and ``metrics/contraction.cc_steps_per_solve``,
``contraction.cc.span_ms``, ``contraction.forest_discarded_ms``,
``contraction.dead_slot_pct``, ``loop.program_syncs_per_solve``) on
hand-built spans: they read only the window's solves, the last
``len(run.records)``, and ignore spans an earlier run left in the same
process; they report nothing where the recorder dropped spans, holds too
few solves or none, or the program records no spans at all. Then one
traced run of the cell's harness on the CPU, at a 12x16 image."""
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from ramabench import harness, manifest, program_spans  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import phases  # noqa: E402
from repro_torch.obs.spans import Span  # noqa: E402

MAN = manifest.Manifest()
NEW = ("contraction.cc_steps_per_solve", "contraction.cc.span_ms",
       "contraction.forest_discarded_ms", "contraction.dead_slot_pct",
       "loop.program_syncs_per_solve")


def read(name, run):
    return manifest.reader(name)(run)


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

    def solve(self, rounds, syncs):
        """One solve: ``rounds`` is a list of (slots, live edges, forest
        used, forest ms, [(cc steps, cc ms), ...])."""
        self.tid += 1
        s = self.add("solve", None, counters={
            "solver_syncs_total.cc_check": syncs - 1,
            "solver_syncs_total.round_exit": 1,
            "other_total.merge": 999})
        for r, (slots, live, used, f_ms, ccs) in enumerate(rounds):
            rd = self.add("round", s, r=r, slots=slots, live_edges=live)
            c = self.add("contraction", rd, r=r)
            f = self.add("contraction.forest", c, r=r, used=used,
                         device_ms=f_ms)
            for steps, ms in ccs:
                self.add("contraction.cc", f, r=r, site="forest_try",
                         steps=steps, device_ms=ms)


def fake_run(n_records, traced=True):
    run = harness.Run(cell={}, config={}, plan=None, traced=traced)
    run.records = [{"host": {}} for _ in range(n_records)]
    run.trace = {} if traced else None
    return run


@pytest.fixture
def spans():
    b = SpanMaker()
    # an earlier run in the same process: never read
    b.solve([(100, 100, True, 50.0, [(400, 9.0)])], syncs=77)
    # the window's two solves
    b.solve([(100, 100, False, 2.0, [(8, 1.0), (12, 1.5)]),
              (100, 40, True, 3.0, [(16, 2.0)])], syncs=10)
    b.solve([(100, 10, False, 4.0, [(4, 0.5)])], syncs=20)
    yield b
    b.rec.clear()


def test_readers_take_the_last_solves_only(spans):
    run = fake_run(2)
    assert read("contraction.cc_steps_per_solve", run) == \
        (8 + 12 + 16 + 4) / 2
    assert read("contraction.cc.span_ms", run) == \
        (1.0 + 1.5 + 2.0 + 0.5) / 2
    assert read("loop.program_syncs_per_solve", run) == (10 + 20) / 2


def test_dead_slot_share_is_over_the_window_rounds(spans):
    # slots 100 + 100 + 100, live 100 + 40 + 10
    assert read("contraction.dead_slot_pct", fake_run(2)) == \
        pytest.approx(100.0 * (300 - 150) / 300)
    assert read("contraction.dead_slot_pct", fake_run(3)) == \
        pytest.approx(100.0 * (400 - 250) / 400)


def test_discarded_forest_counts_only_unused_forests(spans):
    # the rounds whose forest was not used: 2.0 and 4.0 ms
    assert read("contraction.forest_discarded_ms", fake_run(2)) == \
        (2.0 + 4.0) / 2
    assert read("contraction.forest_discarded_ms", fake_run(1)) == 4.0


def test_nothing_where_spans_are_dropped_missing_or_short(spans):
    assert all(read(n, fake_run(4)) is None for n in NEW)   # too few solves
    assert all(read(n, fake_run(2, traced=False)) is None for n in NEW)
    spans.rec.n_dropped = 1
    assert all(read(n, fake_run(2)) is None for n in NEW)
    spans.rec.clear()
    assert all(read(n, fake_run(1)) is None for n in NEW)


def test_nothing_from_a_program_without_spans(spans, monkeypatch):
    monkeypatch.delattr(obs, "solver_spans")
    assert program_spans.window(fake_run(2)) is None
    assert all(read(n, fake_run(2)) is None for n in NEW)


def test_device_spans_need_device_times(spans):
    del spans.rec.spans[-1].args["device_ms"]
    run = fake_run(2)
    assert read("contraction.cc.span_ms", run) is None
    assert read("contraction.cc_steps_per_solve", run) is not None


def test_traced_run_of_the_cell_on_the_cpu(monkeypatch):
    cell = MAN.cell("cityscapes.pd")
    config, traffic = MAN.config(cell), manifest.traffic(cell["traffic"])
    config["instance"].update(h=12, w=16)
    traffic["count"] = 1
    obs.solver_spans().clear()
    # count the CPU's reads as a card's syncs, so the sites show here
    monkeypatch.setattr(phases, "SYNC_DEVICES", ("cuda", "cpu"))
    before = {k: v["value"] for k, v in
              obs.solver_metrics().snapshot().items()}
    result, _, run = harness.run_cell(
        cell, config, traffic, manifest.limits(cell["name"]), 2**31 + 11,
        0.0, True, torch.device("cpu"), time.perf_counter(),
        MAN.metrics(cell, True))
    assert result["correct"]
    got = result["metrics"]
    spans = obs.solver_spans().spans
    solves = [s for s in spans if s.name == "solve"]
    assert len(solves) == len(run.records) == 1   # the window's solve only
    syncs = sum(n for k, n in solves[0].args["counters"].items()
                if k.startswith("solver_syncs_total."))
    assert got["loop.program_syncs_per_solve"]["value"] == syncs > 0
    assert got["contraction.cc_steps_per_solve"]["value"] == sum(
        s.args["steps"] for s in spans if s.name == "contraction.cc") > 0
    assert 0 < got["contraction.dead_slot_pct"]["value"] < 100
    # no card: no CUDA events, so no span times
    assert "contraction.cc.span_ms" not in got
    assert "contraction.forest_discarded_ms" not in got
    after = {k: v["value"] for k, v in
             obs.solver_metrics().snapshot().items()}
    # the untraced warm-up counted its syncs too
    assert sum(v - before.get(k, 0) for k, v in after.items()
               if k.startswith("solver_syncs_total.")) > syncs
