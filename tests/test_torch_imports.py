"""The port stands alone: nothing under src/repro_torch, and no line of
chip_smoke.py, tools/serve_ab.py or the port's examples
(examples/torch_*.py), imports jax or the reference package ``repro``."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
EXAMPLE_FILES = sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize(
    "path", PORT_FILES + EXAMPLE_FILES + [ROOT / "chip_smoke.py",
                                          ROOT / "tools" / "serve_ab.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_import_graph_has_no_jax_or_reference():
    # A fresh interpreter: importing the whole port (and the smoke
    # script's module) pulls in neither jax nor repro.
    code = (
        "import sys, runpy\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels, "
        "repro_torch.apps, repro_torch.configs, repro_torch.models, "
        "repro_torch.serve, repro_torch.train, repro_torch.launch.train, "
        "repro_torch.launch.serve, "
        "repro_torch.tune, repro_torch.obs, repro_torch.obs.cli, "
        "repro_torch.analysis, repro_torch.shard, repro_torch.shard.launch\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, "
        "run_name='not_main')\n"
        f"sys.path.insert(0, {str(ROOT / 'examples')!r})\n"
        + "".join(f"runpy.run_path({str(p)!r}, run_name='not_main')\n"
                  for p in EXAMPLE_FILES) +
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
