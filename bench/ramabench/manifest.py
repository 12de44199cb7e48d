"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix;
the harness reads ``bench/configs/<config>.json`` (the manifest's
``file``), the generator that configuration's ``instance`` names,
``bench/generators/<generator>.py``, ``bench/traffic/<traffic>.json``,
``bench/limits/<cell>.json`` and, for each metric the cell reports,
``bench/metrics/<metric>.py``. Nothing here knows a cell by name.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
GENERATORS = BENCH / "generators"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Manifest:
    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.data = json.loads(Path(path).read_text())
        self.root = Path(path).resolve().parent

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, cell: dict) -> dict:
        entry = next(c for c in self.data["configs"]
                     if c["name"] == cell["config"])
        return json.loads((self.root / entry["file"]).read_text())

    def metrics(self, cell: dict, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics (``traced`` false) or per-layer
        metrics (true), in manifest order."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.data[key]
                if "workloads" not in m or cell["name"] in m["workloads"]]


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> dict:
    """Name -> limit of each number the cell's judge compares."""
    data = json.loads((BENCH / "limits" / f"{cell_name}.json").read_text())
    return {k: float(v["limit"]) for k, v in data["numbers"].items()}


def _load(path: Path, kind: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"ramabench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(run)`` function of ``bench/metrics/<metric>.py``."""
    return _load(BENCH / "metrics" / f"{metric}.py", "metric", metric).read


def reference(name: str):
    """The plain reference module ``bench/reference/<name>.py``."""
    return _load(BENCH / "reference" / f"{name}.py", "reference", name)


def generator(name: str):
    """The instance generator module ``bench/generators/<name>.py``:
    ``make(seed=..., chord_slots=..., **settings)``, called by keyword,
    returns a :class:`ramabench.instances.HostInstance` (distinct pairs
    ``u < v``, int32 ids in ``[0, num_nodes)``, float32 costs,
    ``pad_edges = num_edges + chord_slots``, ``planted`` labels of every
    node), and ``SMALL`` holds settings that a CPU test can hold."""
    path = GENERATORS / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        have = sorted(p.stem for p in GENERATORS.glob("*.py"))
        raise ValueError(f"no instance generator {name!r}: "
                         f"{GENERATORS} has {have}")
    return _load(path, "generator", name)
