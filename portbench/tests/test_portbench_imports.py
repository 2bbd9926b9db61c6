"""What the harness may import: never JAX or the JAX package (top-level
names compared whole), and, in the reference, nothing of the program."""
import ast
import pathlib

import pytest

from portbench import run

PB = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.models",
                                  "jaxtyping", "reprolib"]) == []
    assert run.forbidden_modules(["repro.core", "jax._src", "flax"]) == \
        ["flax", "jax", "repro"]
