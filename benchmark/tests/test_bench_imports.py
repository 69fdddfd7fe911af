"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Names are compared whole by
their top-level part: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "affganwriting_tpu"}


def top_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".", 1)[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_apart(path):
    assert "affganwriting_torch" not in top_imports(path)


def test_whole_names():
    """The port's name starts with the JAX package's and is still allowed."""
    assert "affganwriting_torch" not in JAX
    assert top_imports(BENCH / "harness" / "serve.py") >= {"torch"}
