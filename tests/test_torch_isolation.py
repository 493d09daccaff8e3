"""The port stands alone: ``flextree_tpu_torch`` and its chip scripts
(``chip_smoke.py``, ``chip_flash_mutants.py``) import neither ``jax`` nor the JAX package (not even its JAX-free
modules), and the smoke script refuses to report without a GPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "flextree_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flextree_tpu")


def _port_sources():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15, files
    for sub in ("analysis", "planner", "tools", "schedule", "parallel"):
        assert PKG / sub / "__init__.py" in files, sub
    return files + [ROOT / "chip_smoke.py", ROOT / "chip_flash_mutants.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_the_port(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    """Import every module of the port and the chip scripts in a fresh
    interpreter; neither jax nor the JAX package may be loaded after."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PKG.rglob("*.py")
    )
    code = "\n".join([
        "import importlib, sys",
        f"sys.path.insert(0, {str(ROOT)!r})",
        f"for m in {modules!r}:",
        "    importlib.import_module(m.removesuffix('.__init__'))",
        "import chip_smoke, chip_flash_mutants",
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]",
        "print(len(sys.modules)); assert not bad, bad",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_without_gpu_or_without_the_repo(tmp_path):
    """Without a card it exits non-zero and prints no result; copied
    alone into an empty directory it cannot run either."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke test would really run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
