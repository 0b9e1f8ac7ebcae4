"""Nothing of JAX in the benchmark: the run's check by top-level names, and
the sources' imports."""

import ast

import pytest

from portbench.harness.imports import foreign
from portbench.harness.spec import ROOT

BENCH = ROOT / "portbench"
SOURCES = sorted(BENCH.rglob("*.py"))


def test_top_level_names_compared_whole():
    assert foreign(["canny_edge_tpu_torch", "canny_edge_tpu_torch.models",
                    "jaxtyping", "flaxen", "canny_edge_tpu_x", "numpy"]) == []
    assert foreign(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                    "canny_edge_tpu", "canny_edge_tpu.golden", "torch"]) == [
        "canny_edge_tpu", "canny_edge_tpu.golden", "flax.linen", "jax",
        "jax.numpy", "jaxlib.xla_client"]


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert foreign(imported(path)) == []


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_only_the_program_module_imports_the_program(path):
    """The reference, the metrics and the drivers take nothing from the
    program; only ``harness/program.py`` (and tests comparing with it)
    import it."""
    top = {n.split(".")[0] for n in imported(path)}
    if path.parent.name == "tests" or path.name == "program.py":
        return
    assert "canny_edge_tpu_torch" not in top
