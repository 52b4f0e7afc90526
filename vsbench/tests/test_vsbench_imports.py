"""No module of the benchmark imports JAX or the JAX package (whole
top-level names: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""
import ast

import pytest

from vsbench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vectorsearch_tpu"}
FILES = sorted((ROOT / "vsbench").rglob("*.py"))


def top_names(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not FORBIDDEN & set(top_names(path))


@pytest.mark.parametrize("path", sorted((ROOT / "vsbench" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_names(path))
    assert "vectorsearch_tpu_torch" not in names and not FORBIDDEN & names
    rel = [n for n in ast.walk(ast.parse(path.read_text()))
           if isinstance(n, ast.ImportFrom) and n.level > 0]
    assert all(n.level == 1 for n in rel)  # only its own package


def test_top_level_name_is_compared_whole():
    assert "vectorsearch_tpu_torch".split(".")[0] not in FORBIDDEN
