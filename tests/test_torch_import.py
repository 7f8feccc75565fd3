"""The PyTorch port (`trlx_tpu_torch`) stands alone: importing every one
of its modules pulls in neither JAX nor the JAX package, and no module
of it names them in an import statement."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "trlx_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "trlx_tpu")


def _modules():
    import trlx_tpu_torch

    return sorted(
        m.name for m in pkgutil.walk_packages(trlx_tpu_torch.__path__, "trlx_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "trlx_tpu_torch.inference.engine" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_no_forbidden_import_statement(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_port_scripts_import_without_jax():
    """chip_smoke.py and the port's curve script (which loads the JAX
    curve script by path for its task and probes) pull in no JAX."""
    code = (
        "import importlib.util, json, sys\n"
        "mods = {}\n"
        "for name, path in (('chip_smoke', 'chip_smoke.py'),\n"
        "                   ('parity_torch', 'scripts/parity_randomwalks_torch.py')):\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    mods[name] = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mods[name])\n"
        "metric_fn, prompts, walks = mods['parity_torch']._task()\n"
        "assert len(prompts) == 21 and len(walks) == 1000\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
