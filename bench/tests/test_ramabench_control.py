"""The control of each cell's judge, at a size a CPU test holds: the
reference put in the program's place in bfloat16 has to fail the cell's
limits, on three seeds; the program's own answers at that size pass
them (``test_ramabench_faults``). ``bench/tools/readings.py`` reads the
same control at the cells' own sizes on the card."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from ramabench import control, manifest  # noqa: E402

MAN = manifest.Manifest()
CELLS = [w["name"] for w in MAN.data["workloads"]]


def small(cell_name: str):
    cell = MAN.cell(cell_name)
    config, traffic = MAN.config(cell), manifest.traffic(cell["traffic"])
    config["instance"].update(h=24, w=32)
    return config, traffic, manifest.limits(cell_name)


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**33 + 7])
@pytest.mark.parametrize("cell", CELLS)
def test_reference_in_bf16_fails_the_limits(cell, seed):
    config, traffic, limits = small(cell)
    values = control.reference_in_place(config, traffic, seed, limits)
    assert control.fails(values, limits), values
