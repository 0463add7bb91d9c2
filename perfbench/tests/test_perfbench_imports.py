"""Nothing under perfbench/ imports JAX or the JAX package, and the
reference imports nothing of the program: the top-level module name of
every import, compared whole (the program's name begins with the JAX
package's)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "contextgs_tpu"}
PROGRAM = "contextgs_tpu_torch"
FILES = sorted(ROOT.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def module_strings(path: Path) -> set:
    """Top-level names of the dotted module paths a file names in its
    string constants (the targets its spans and faults wrap)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and "." in node.value and " " not in node.value
                and node.value.split(".")[0].isidentifier()):
            out.add(node.value.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not (top_level_imports(path) | module_strings(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((ROOT / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path) | module_strings(path)


def test_the_check_compares_whole_names():
    assert PROGRAM not in FORBIDDEN
    assert ".".join([PROGRAM[:-len("_torch")], "models"]).split(".")[0] \
        in FORBIDDEN
