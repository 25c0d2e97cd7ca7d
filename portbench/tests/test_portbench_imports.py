"""No file of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Top-level module
names are compared whole: ``repro_torch`` is not ``repro``."""

import ast

import pytest
from conftest import ROOT

BENCH = ROOT / "portbench"
FILES = sorted(BENCH.rglob("*.py"))


def _imports(source):
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    names = set(_imports(path.read_text()))
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in names


def test_check_compares_whole_names():
    src = "import repro_torch.core\nfrom repro_torch import x\nimport jax.numpy\n"
    assert set(_imports(src)) == {"repro_torch", "jax"}
