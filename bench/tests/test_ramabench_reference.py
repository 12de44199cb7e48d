"""The plain reference flags planted faults: a relabelled node, an
objective off by one edge, a bound above the objective, a state left
unchanged, a broken triangle; and reads 0 on sound answers. The grid
generator is the program's, draw for draw."""
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from ramabench import instances, manifest  # noqa: E402

ref = manifest.reference("multicut")
INST = instances.grid(10, 12, seed=3, chord_slots=8)


def planted_answer(inst=INST) -> dict:
    _, labels = np.unique(inst.planted, return_inverse=True)
    cut = labels[inst.u] != labels[inst.v]
    obj = float(inst.cost[cut].astype(np.float64).sum())
    return dict(labels=labels, objective=obj,
                lower_bound=ref.trivial_bound(inst.cost),
                n_clusters=int(labels.max()) + 1)


def test_sound_answer_reads_zero():
    ans = planted_answer()
    nums = ref.judge(INST, ans)
    assert nums["partition_faults"] == 0
    assert nums["objective_rel_err"] == 0.0
    assert nums["bound_excess"] == 0.0
    assert nums["cluster_share"] == ans["n_clusters"] / INST.num_nodes


def test_relabelled_node_is_caught():
    ans = planted_answer()
    lab = ans["labels"].copy()
    # move one node to another cluster: the cut changes, the objective not
    i = next(i for i in range(len(lab))
             if (lab[INST.u[INST.v == i]] != lab[i]).any()
             or (lab[INST.v[INST.u == i]] != lab[i]).any())
    lab[i] = (lab[i] + 1) % ans["n_clusters"]
    nums = ref.judge(INST, dict(ans, labels=lab))
    assert nums["objective_rel_err"] > 1e-3 or nums["partition_faults"] > 0


def test_label_outside_the_clusters_is_caught():
    ans = planted_answer()
    lab = ans["labels"].copy()
    lab[0] = ans["n_clusters"]
    assert ref.judge(INST, dict(ans, labels=lab))[
        "partition_faults"] > 0


def test_objective_off_by_one_edge_is_caught():
    ans = planted_answer()
    cut = ans["labels"][INST.u] != ans["labels"][INST.v]
    e = int(np.nonzero(cut)[0][0])
    nums = ref.judge(INST, dict(ans, objective=ans["objective"]
                                - float(INST.cost[e])))
    assert nums["objective_rel_err"] >= abs(float(INST.cost[e])) / max(
        1.0, abs(ans["objective"])) * 0.99


@pytest.mark.parametrize("lb", [lambda a: a["objective"] + 1.0,
                                lambda a: 0.5, lambda a: float("nan"),
                                lambda a: float("inf")],
                         ids=["above_objective", "above_one_cluster",
                              "nan", "inf"])
def test_bound_above_an_objective_is_caught(lb):
    ans = planted_answer()
    nums = ref.judge(INST, dict(ans, lower_bound=lb(ans)))
    assert nums["bound_excess"] > 0


def test_state_left_unchanged_reads_one_cluster_a_node():
    n = INST.num_nodes
    ans = dict(labels=np.arange(n), objective=float(
        INST.cost.astype(np.float64).sum()),
        lower_bound=ref.trivial_bound(INST.cost), n_clusters=n)
    nums = ref.judge(INST, ans)
    assert nums["cluster_share"] == 1.0
    assert nums["objective_rel_err"] < 1e-12      # sound, but unchanged


def triangle_cycles():
    """One triangle 0-1-12 of the 10x12 grid: edges (0, 1) and (0, 12) of
    the instance, closed by a chord (1, 12) in the first free slot."""
    E = INST.num_edges
    ids = {(int(a), int(b)): k for k, (a, b) in enumerate(zip(INST.u,
                                                              INST.v))}
    e01, e0w = ids[(0, 1)], ids[(0, 12)]
    chord_u = np.array([1, 0, 0, 0, 0, 0, 0, 0], dtype=np.int32)
    chord_v = np.array([12, 0, 0, 0, 0, 0, 0, 0], dtype=np.int32)
    chord_ok = np.array([True] + [False] * 7)
    return dict(tri=np.array([[e01, e0w, E], [0, 0, 0]], dtype=np.int32),
                valid=np.array([True, False]), first_chord=E,
                chord_u=chord_u, chord_v=chord_v,
                chord_cost=np.zeros(8, dtype=np.float32),
                chord_valid=chord_ok)


def test_closed_triangle_with_a_chord_passes():
    assert ref.cycle_faults(INST, triangle_cycles()) == 0


@pytest.mark.parametrize("break_it", [
    lambda c: c["tri"].__setitem__((0, 2), 5),          # not closed
    lambda c: c["chord_cost"].__setitem__(0, 0.5),      # chord with a cost
    lambda c: c["chord_valid"].__setitem__(0, False),   # chord not written
    lambda c: c["tri"].__setitem__((0, 0), 10 ** 7),    # edge out of range
], ids=["open", "costly_chord", "missing_chord", "out_of_range"])
def test_broken_triangle_is_caught(break_it):
    c = triangle_cycles()
    break_it(c)
    assert ref.cycle_faults(INST, c) == 1


def test_generator_is_the_programs_draw_for_draw():
    torch = pytest.importorskip("torch")
    from repro_torch.core.graph import grid_instance
    prog = grid_instance(10, 12, seed=3, pad_edges=INST.pad_edges,
                         device="cpu")
    mine = instances.to_program(INST, torch.device("cpu"))
    for a, b in zip(prog, mine):
        assert torch.equal(a, b)


def test_to_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, -2.5,
                  1.00390625], dtype=np.float32)
    got = ref.to_bf16(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -7, -2.5, 1.0]


def test_bound_lift_reads_the_bound_above_the_trivial_one():
    ans = planted_answer()
    triv = ref.trivial_bound(INST.cost)
    flat = ref.judge(INST, dict(ans, lower_bound=triv))["lift_inv"]
    raised = ref.judge(INST, dict(ans, lower_bound=0.8 * triv))["lift_inv"]
    assert flat > 9e5                           # no lift at all
    assert raised == pytest.approx(1 / (1e-6 + 0.2))
    assert ref.judge(INST, dict(ans, lower_bound=1.5 * triv))["lift_inv"] == flat  # below trivial: no lift


def test_triangle_count_reads_one_without_a_triangle():
    c = triangle_cycles()
    assert ref.tri_inv(c) == 0.5
    c["valid"][:] = False
    assert ref.tri_inv(c) == 1.0


def gap_pct(lb_scale: float, obj_shift: float = 0.0) -> float:
    from types import SimpleNamespace
    ans = planted_answer()
    triv = ref.trivial_bound(INST.cost)
    nums = ref.judge(INST, ans)
    rec = dict(recount=nums["recount"] + obj_shift, trivial=nums["trivial"],
               host=dict(ans, lower_bound=lb_scale * triv))
    return manifest.reader("pd_gap_pct")(SimpleNamespace(
        done_in_window=[rec, rec]))


def test_pd_gap_rises_with_a_weaker_bound_and_a_worse_objective():
    assert gap_pct(1.1) > gap_pct(1.0) > gap_pct(0.9)
    assert gap_pct(1.0, obj_shift=5.0) > gap_pct(1.0)
    ans = planted_answer()
    obj, triv = ans["objective"], ref.trivial_bound(INST.cost)
    assert gap_pct(0.9) == pytest.approx(
        100 * (obj - 0.9 * triv) / abs(triv))
