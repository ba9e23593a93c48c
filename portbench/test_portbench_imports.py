"""No module under portbench imports JAX or the JAX package (top-level
module names compared whole: the program's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "stardis_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if ".build" not in p.parts)


def imported_top_levels(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p.parts],
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_is_independent_of_the_program(path):
    names = imported_top_levels(path)
    assert "stardis_tpu_torch" not in names and "portbench" not in names


def test_the_check_itself_sees_names_whole():
    assert imported_top_levels(HERE / "drivers" / "serve.py") >= {"stardis_tpu_torch"}
    assert "stardis_tpu_torch".split(".")[0] not in FORBIDDEN
