"""Nothing under shedbench/ imports JAX or the JAX package, comparing
top-level module names whole (``repro_torch`` is another name), and the
yardstick imports nothing of the program."""
import ast

import pytest

from shedbench_tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_yardstick_imports_nothing_of_the_program():
    for path in (BENCH / "yardstick").glob("*.py"):
        assert "repro_torch" not in top_level_imports(path), path


def test_the_check_itself_compares_whole_names():
    assert {"repro_torch"} & FORBIDDEN == set()
    assert "repro_torch".split(".")[0] not in FORBIDDEN
