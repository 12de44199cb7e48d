"""The contraction set's forest gate: ``choose_contraction_set`` and its
sharded twin read on the host whether the matching reached
``switch_frac * |V|`` edges and run the spanning forest only where it did
not.

The set equals the JAX package's (which computes both and selects on the
device) bit for bit, replicated and sharded at S = 1, on instances and
``switch_frac`` values that take every branch: the matching suffices, or
it falls short and the forest's set is taken (the grid, the clusters) or
thrown away because it is smaller than the matching (the random graph at
``switch_frac`` 1.0). Under ``obs.solver_tracing()`` a
``contraction.forest`` span opens exactly where the matching fell short,
and the gate counts one host sync a call (site ``forest_gate``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
pytest.importorskip("jax")

from repro.core import contraction as jc  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.convert import instance_from_numpy  # noqa: E402
from repro_torch.core import contraction as tc  # noqa: E402
from repro_torch.obs import phases  # noqa: E402

INSTANCES = {
    "grid": lambda: jg.grid_instance(16, 18, seed=7, pad_edges=1300),
    "cluster": lambda: jg.cluster_instance(70, seed=3, pad_edges=1700,
                                           pad_nodes=80),
    "random": lambda: jg.random_instance(60, 0.15, seed=0, pad_edges=1024,
                                         pad_nodes=64),
}
SWITCH = (0.0, 0.1, 1.0)
CONTRACT = (0.0, 0.5)


def _pair(name):
    ji = INSTANCES[name]()
    return ji, instance_from_numpy(*[np.asarray(x) for x in ji],
                                   device="cpu")


def _branch(ti, switch_frac, contract_frac):
    """The matching's and the forest's sizes, computed apart from the
    gate, and whether the matching falls short."""
    min_cost = 0.0
    if contract_frac > 0.0:
        cmax = torch.where(ti.edge_valid, ti.cost,
                           torch.zeros_like(ti.cost)).max()
        min_cost = contract_frac * cmax.clamp(min=0.0)
    n_match = int(tc.maximum_matching(ti, min_cost=min_cost).sum())
    n_forest = int(tc.spanning_forest_contraction(ti,
                                                  min_cost=min_cost).sum())
    short = n_match < switch_frac * int(ti.node_valid.sum())
    return n_match, n_forest, short


def _gate_syncs():
    key = f"{phases.SYNCS}.forest_gate"
    return obs.solver_metrics().snapshot().get(key, {"value": 0})["value"]


def test_instances_take_every_branch():
    """The cases below reach each branch: the matching suffices; it
    falls short and the forest is taken; it falls short and the forest,
    smaller than the matching, is thrown away."""
    seen = set()
    for name in INSTANCES:
        ti = _pair(name)[1]
        for sf in SWITCH:
            for cf in CONTRACT:
                n_match, n_forest, short = _branch(ti, sf, cf)
                seen.add("match" if not short else
                         "forest" if n_forest >= n_match else "discarded")
    assert seen == {"match", "forest", "discarded"}


@pytest.mark.parametrize("contract_frac", CONTRACT)
@pytest.mark.parametrize("switch_frac", SWITCH)
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_gated_set_equals_the_reference(name, switch_frac, contract_frac,
                                        monkeypatch):
    ji, ti = _pair(name)
    want = np.asarray(jc.choose_contraction_set(
        ji, 3, 4, switch_frac, contract_frac))
    n_match, n_forest, short = _branch(ti, switch_frac, contract_frac)
    # count the CPU's reads as a card's syncs, so the gate's site shows
    monkeypatch.setattr(phases, "SYNC_DEVICES", ("cuda", "cpu"))
    obs.solver_spans().clear()
    before = _gate_syncs()
    with obs.solver_tracing():
        got = tc.choose_contraction_set(ti, 3, 4, switch_frac,
                                        contract_frac)
        sharded = tc.choose_contraction_set_sharded(
            ti.u, ti.v, ti.cost, ti.edge_valid, ti.node_valid, 3, 4,
            switch_frac, contract_frac, 1, None)
    spans = list(obs.solver_spans().spans)
    obs.solver_spans().clear()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sharded.numpy(), want)
    assert _gate_syncs() - before == 2          # one a call
    forest = [s for s in spans if s.name == "contraction.forest"]
    assert len(forest) == (2 if short else 0)
    assert all(s.args["used"] == (n_forest >= n_match) for s in forest)
    cc_sites = {s.args["site"] for s in spans if s.name == "contraction.cc"}
    assert cc_sites == ({"forest_try", "forest_keep"} if short else set())
