"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names present: names and units of the allowed characters, each per-layer
metric's ``moves`` reported in each of its cells, each cell reporting
``setup_s``, another end-to-end metric and a per-layer one."""
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from ramabench import manifest  # noqa: E402

DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in DATA["workloads"]}
E2E = {m["name"]: m for m in DATA["end_to_end"]}
METRICS = DATA["end_to_end"] + DATA["per_layer"]
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def cells_of(metric: dict) -> list[str]:
    return metric.get("workloads", list(CELLS))


def test_top_level_keys_and_sizes():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(DATA).encode()) <= 64 * 1024
    assert 1 <= len(DATA["paths"]) <= 16
    for p in DATA["paths"]:
        assert PATH.match(p) and ".." not in p.split("/") \
            and not p.startswith("/") and (ROOT / p).is_dir()
    assert 1 <= len(DATA["command"]) <= 32
    assert all(TEXT.match(w) for w in DATA["command"])
    assert isinstance(DATA["run_seconds"], int) \
        and 1 <= DATA["run_seconds"] <= 51
    assert 1 <= len(DATA["configs"]) <= 24
    assert 1 <= len(DATA["workloads"]) <= 24
    assert 1 <= len(DATA["end_to_end"]) <= 16
    assert 1 <= len(DATA["per_layer"]) <= 128


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entry(m):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if m["name"] in E2E else {"layer", "moves"}
    assert set(m) - {"workloads"} == keys
    assert manifest.NAME.match(m["name"]) and manifest.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m["name"] in E2E:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in E2E
        for cell in cells_of(m):      # its end-to-end metric is there too
            assert cell in cells_of(E2E[m["moves"]])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(c in CELLS for c in cells_of(m))
    assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", list(CELLS), ids=str)
def test_cell_entry(cell):
    w = CELLS[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert all(manifest.NAME.match(w[k]) for k in ("name", "config",
                                                   "traffic"))
    assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    assert w["config"] in {c["name"] for c in DATA["configs"]}
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert manifest.limits(cell)
    e2e = [m["name"] for m in DATA["end_to_end"] if cell in cells_of(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in cells_of(m) for m in DATA["per_layer"])


def test_configs_and_uniqueness():
    files = [c["file"] for c in DATA["configs"]]
    assert len(set(files)) == len(files)
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert manifest.NAME.match(c["name"]) and TEXT.match(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(manifest.NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(DATA["paths"][0] + "/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] \
            == c["name"]
        assert any(w["config"] == c["name"] for w in DATA["workloads"])
    for group in (DATA["configs"], DATA["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in DATA["workloads"])
    assert four <= max(1, len(DATA["workloads"]) // 4)
