"""No module of the benchmark imports JAX, the JAX package or the old
benchmarks, and the reference imports nothing of the program. Module
names are compared by their top-level name, whole: ``repro_torch`` is not
``repro``."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    HERE)))
def test_no_jax_no_reference_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro",
                                          "benchmarks"}


def test_reference_is_independent_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert not top_level_imports(path) & {"repro_torch", "portbench"}


def test_the_run_compares_loaded_names_whole():
    from portbench import harness
    assert harness.forbidden_modules(["repro_torch", "repro_torch.api",
                                      "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro_torch", "repro.api", "jax",
                                      "flax.linen"]) == ["flax", "jax",
                                                         "repro"]
