"""The whole-name import check, and the benchmark's own sources: nothing
in ``bench/`` imports JAX, the JAX package or the JAX package's
benchmarks, and the reference imports nothing of the program."""
import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from ramabench.modules import forbidden  # noqa: E402

SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.api", "ramabench.harness"], []),
    (["repro"], ["repro"]),
    (["repro.core.graph", "repro_torch.core.graph"], ["repro.core.graph"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]),
    (["reproduce", "jaxtyping", "flaxen"], []),
])
def test_forbidden_by_whole_top_level_name(names, bad):
    assert forbidden(names) == bad


def imported(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    names = imported(path)
    assert not forbidden(names) and "benchmarks" not in names


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "numpy"}
