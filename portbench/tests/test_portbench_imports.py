"""What the benchmark's sources import and read: nothing of JAX or the
JAX package anywhere under portbench/ (top-level names compared
whole), nothing of the port under reference/, and nothing of the JAX
package's benchmark folder or its BENCH_*.json files."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"torch", "portbench", "__future__"}
    mods = {n.module for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.ImportFrom) and n.module}
    assert all(m == "__future__" or m == "torch" or m.startswith("torch.")
               or m.startswith("portbench.reference") for m in mods)


def test_whole_names_compared():
    """`repro_torch` begins with `repro` and is allowed."""
    assert "repro_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p != Path(__file__).resolve()],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reads_no_jax_benchmarks(path):
    """(This file names what it looks for, so it is left out.)"""
    text = path.read_text()
    assert "BENCH_" not in text
    assert '"benchmarks' not in text and "'benchmarks" not in text
