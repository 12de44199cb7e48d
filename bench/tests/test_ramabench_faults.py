"""A whole run of the solve cell's harness on the CPU, past the look for a
card, at a size a test holds (a 12x16 image), first with the program as
it is and then with its timed path broken underneath: ``correct`` comes
out true once and false for every fault the cell can have (a solve that
returns its state unchanged, a message passing that leaves its costs
unchanged, a separation that finds no triangle, an answer altered where
it is produced, a solve that raises). The cell solves one image a call,
so it has no batch to halve and no exchange between chips to leave out.
One test, marked ``cuda``, runs the cell's harness on a card."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from ramabench import control, harness, manifest  # noqa: E402
from repro_torch import api  # noqa: E402

MAN = manifest.Manifest()
CPU = torch.device("cpu")
SOLVE = api.solve


def small(cell_name: str):
    cell = MAN.cell(cell_name)
    config, traffic = MAN.config(cell), manifest.traffic(cell["traffic"])
    config["instance"].update(h=12, w=16)
    traffic["count"] = 1
    return cell, config, traffic, manifest.limits(cell_name)


def run(cell_name: str, device=CPU, seconds: float = 0.0):
    cell, config, traffic, limits = small(cell_name)
    result, checks, _ = harness.run_cell(
        cell, config, traffic, limits, 2**31 + 11, seconds, False, device,
        time.perf_counter(), MAN.metrics(cell, False))
    return result, checks


def unchanged(inst, *args, **kw):
    """A solve that returns its input state: every node alone."""
    n = inst.num_nodes
    cost = torch.where(inst.edge_valid, inst.cost, 0.0)
    res = SOLVE(inst, *args, **kw)
    return res._replace(
        labels=torch.arange(n, dtype=torch.int32, device=inst.device),
        objective=cost.sum(),
        lower_bound=torch.clamp(cost, max=0.0).sum(),
        n_clusters=torch.full_like(res.n_clusters, n))


def relabel_one(res):
    """The answer altered where it is produced: one node moved into a
    neighbouring cluster."""
    lab = res.labels.clone()
    k = int(res.n_clusters[int(res.rounds) - 1])
    lab[0] = (int(lab[0]) + 1) % k if k > 1 else 1
    return res._replace(labels=lab)


def altered(inst, *args, **kw):
    return relabel_one(SOLVE(inst, *args, **kw))


def raises(inst, *args, **kw):
    raise RuntimeError("planted fault")


def test_solve_cell_sound_run_is_correct():
    result, checks = run("cityscapes.pd")
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert {"setup_s", "solve_s", "pd_gap_pct"} <= set(result["metrics"])


@pytest.mark.parametrize("fault,number", [
    (unchanged, "cluster_share"), (altered, "objective_rel_err"),
    (raises, None)], ids=["state_unchanged", "answer_altered", "raises"])
def test_solve_cell_fault_is_not_correct(monkeypatch, fault, number):
    calls = []

    def broken(inst, *args, **kw):
        calls.append(1)             # the set-up's warm-up runs sound
        return (fault if len(calls) > 1 else SOLVE)(inst, *args, **kw)

    monkeypatch.setattr(api, "solve", broken)
    result, checks = run("cityscapes.pd")
    assert not result["correct"]
    if number is None:
        assert result["failed"] >= 1
    else:
        value, limit = checks[number]
        assert value > limit


@pytest.mark.parametrize("fault,number", [
    ("mp_unchanged", "lift_inv"), ("no_triangles", "tri_inv")])
def test_solve_cell_planted_fault_is_not_correct(fault, number):
    with control.planted(fault):
        result, checks = run("cityscapes.pd")
    assert not result["correct"]
    value, limit = checks[number]
    assert value > limit
    assert checks["partition_faults"][0] == 0   # the answers stay sound
    assert checks["objective_rel_err"][0] <= checks["objective_rel_err"][1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_solve_cell_on_the_card(card):
    result, checks = run("cityscapes.pd", device=card, seconds=0.5)
    assert result["correct"], checks
    assert result["device"]["platform"] == "gpu"
    assert np.isfinite(result["metrics"]["solve_s"]["value"])
