"""Instance generators found by name (``bench/generators/<name>.py``):
the traffic generator draws the Cityscapes cell's images as it always
did, every generator keeps the ``HostInstance`` contract at its ``SMALL``
settings, every configuration's generator makes the sizes its file
states, and a new generator is picked up by adding its file alone."""
import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from ramabench import instances, manifest, traffic  # noqa: E402

DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
GENERATORS = sorted(p.stem for p in manifest.GENERATORS.glob("*.py"))
CITYSCAPES = json.loads(
    (BENCH / "configs" / "cityscapes-512x1024.json").read_text())
SEEDS = (0, 2 ** 31 + 11, 4600000013)
# The program, the JAX package and JAX itself, by top-level name.
FORBIDDEN = {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def fields(inst) -> tuple:
    return inst.u, inst.v, inst.cost, inst.planted


@pytest.mark.parametrize("seed", SEEDS)
def test_cityscapes_plan_is_the_grid_draw_for_draw(seed):
    plan = traffic.make_plan(CITYSCAPES, traffic=manifest.traffic("solve-pd"),
                             seed=seed, max_neg=256)
    assert len(plan.host) == 3 and plan.mode == "pd"
    for i, got in enumerate(plan.host):
        want = instances.grid(512, 1024, seed + i, chord_slots=1024,
                              noise=0.4, n_segments=6, long_range=True)
        for a, b in zip(fields(got), fields(want)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got.num_nodes == want.num_nodes
        assert got.pad_edges == want.pad_edges == got.num_edges + 1024


def imported(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("name", GENERATORS)
def test_generator_keeps_the_contract(name):
    assert not imported(manifest.GENERATORS / f"{name}.py") & FORBIDDEN
    gen = manifest.generator(name)
    seed, chords = 2 ** 31 + 7, 8
    inst = gen.make(seed=seed, chord_slots=chords, **gen.SMALL)
    n, e = inst.num_nodes, inst.num_edges
    assert n > 0 and e > 0
    assert inst.u.dtype == inst.v.dtype == np.int32
    assert inst.cost.dtype == np.float32
    assert inst.u.shape == inst.v.shape == inst.cost.shape == (e,)
    assert (inst.u >= 0).all() and (inst.v < n).all()
    assert (inst.u < inst.v).all()
    pairs = inst.u.astype(np.int64) * n + inst.v
    assert len(np.unique(pairs)) == e
    assert inst.pad_edges == e + chords
    assert inst.planted.shape == (n,)
    again = gen.make(seed=seed, chord_slots=chords, **gen.SMALL)
    for a, b in zip(fields(inst), fields(again)):
        assert np.array_equal(a, b)
    other = gen.make(seed=seed + 1, chord_slots=chords, **gen.SMALL)
    assert other.cost.shape != inst.cost.shape \
        or not np.array_equal(other.cost, inst.cost)


@pytest.mark.parametrize("entry", DATA["configs"], ids=lambda c: c["name"])
def test_generator_makes_the_configurations_sizes(entry):
    config = json.loads((ROOT / entry["file"]).read_text())
    settings = dict(config["instance"])
    gen = manifest.generator(settings.pop("generator"))
    settings.pop("chord_slots_per_repulsive_edge", None)
    inst = gen.make(seed=0, chord_slots=0, **settings)
    assert (inst.num_nodes, inst.num_edges) \
        == (config["nodes"], config["edges"])


RING = '''
import numpy as np
from ramabench.instances import HostInstance

SMALL = dict(n=6)


def make(seed, chord_slots, *, n):
    rng = np.random.default_rng(seed)
    u = np.arange(n - 1, dtype=np.int32)
    return HostInstance(u=u, v=u + 1,
                        cost=rng.normal(size=n - 1).astype(np.float32),
                        num_nodes=n, pad_edges=n - 1 + chord_slots,
                        planted=np.zeros(n, np.int64))
'''


def test_a_new_generator_is_found_by_its_file_alone(tmp_path, monkeypatch):
    (tmp_path / "ring.py").write_text(RING)
    monkeypatch.setattr(manifest, "GENERATORS", tmp_path)
    config = {"instance": {"generator": "ring", "n": 7,
                           "chord_slots_per_repulsive_edge": 2}}
    plan = traffic.make_plan(config, {"count": 2, "mode": "pd"}, seed=5,
                             max_neg=3)
    assert [h.num_nodes for h in plan.host] == [7, 7]
    assert [h.pad_edges for h in plan.host] == [12, 12]
    want = np.random.default_rng(6).normal(size=6).astype(np.float32)
    assert np.array_equal(plan.host[1].cost, want)


@pytest.mark.parametrize("name", ["voxels", "../ramabench/instances", ""])
def test_an_unknown_generator_raises_and_lists_the_files(name):
    config = {"instance": dict(CITYSCAPES["instance"], generator=name)}
    with pytest.raises(ValueError, match="'grid'"):
        traffic.make_plan(config, {"count": 1, "mode": "pd"}, seed=0)


def test_an_unknown_setting_raises():
    config = {"instance": dict(CITYSCAPES["instance"], h=8, w=8, holes=3)}
    with pytest.raises(TypeError, match="holes"):
        traffic.make_plan(config, {"count": 1, "mode": "pd"}, seed=0)
