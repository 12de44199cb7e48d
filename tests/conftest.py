"""Shared fixtures. NOTE: no XLA_FLAGS here — tests run on the single real
CPU device; only the dry-run (launch/dryrun.py) fakes 512 devices, and the
multi-device tests spawn subprocesses with their own env."""
import numpy as np
import pytest

from repro.core.graph import MulticutInstance, make_instance, random_instance


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def tiny_instance():
    """8-node instance small enough for brute force."""
    return random_instance(8, 0.6, seed=0, pad_edges=48, pad_nodes=8)


@pytest.fixture(params=range(4))
def tiny_instances(request):
    return random_instance(9, 0.5, seed=request.param, pad_edges=64,
                           pad_nodes=16)


@pytest.fixture
def triangle_instance():
    """The canonical conflicted triangle: two attractive edges, one
    repulsive. OPT = either join all (cost -1) or cut the triangle apart."""
    #   0 --(+2)-- 1
    #    \        /
    #   (+2)   (-1)
    #      \   /
    #        2
    return make_instance([0, 1, 0], [1, 2, 2], [2.0, -1.0, 2.0], 3,
                         pad_edges=16, pad_nodes=4)
