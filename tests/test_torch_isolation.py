"""barcode_tpu_torch and chip_smoke.py stand alone: neither imports `jax` nor
anything of `barcode_tpu` (the machine with the card has no JAX), and
chip_smoke.py refuses to run without a card or without the package.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

BLOCKER = r'''
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    """Make `import jax`, `import jaxlib` and `import barcode_tpu` fail."""
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "barcode_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import barcode_tpu_torch
names = [m.name for m in pkgutil.walk_packages(barcode_tpu_torch.__path__,
                                               "barcode_tpu_torch.")]
for name in names:
    __import__(name)
import chip_smoke
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "barcode_tpu")]
assert not leaked, leaked
print(len(names), "modules")
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_and_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", BLOCKER], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 20  # every module was imported


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present; chip_smoke.py ran for real")
    assert '"ok"' not in out.stdout
    assert "needs a CUDA card" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    it exits non-zero and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "barcode_tpu_torch" in out.stderr
