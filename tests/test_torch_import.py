"""The port imports torch and numpy only: never jax, never chiaroscuro_tpu,
never the repo's ``tools/``.  Every module is imported (the port's own
``tools`` subpackage among them), and the resident visits, the gradient
entry points and the X1/X2 wrappers by name.

Both checks run in a fresh interpreter, since this test process has
already imported jax (conftest.py).
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import chiaroscuro_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
names = [n for n in names if not n.endswith("__main__")]
for n in names:
    importlib.import_module(n)
from chiaroscuro_tpu_torch.ops.cluster_cuda import (
    any_resident, closest_cluster_diff, closest_resident)
from chiaroscuro_tpu_torch.ops.intersect_cuda import closest_hit
from chiaroscuro_tpu_torch.scene.scene_arrays import params_from_numpy
from chiaroscuro_tpu_torch.tools.cull_experiments import cull_rowhit, cull_rows_kernelized
from chiaroscuro_tpu_torch.tools.dma_min import dma_min
assert "chiaroscuro_tpu_torch.tools.cull_experiments" in names
assert "chiaroscuro_tpu_torch.tools.dma_min" in names
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "chiaroscuro_tpu", "tools"))
print(len(names), bad)
"""


def _python(args, **kw):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120, **kw,
    )


def test_every_module_imports_without_jax():
    proc = _python(["-c", IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 20, proc.stdout   # every subpackage and module
    assert bad == "[]", bad


def test_cli_without_a_card_or_platform_cpu_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI renders on it")
    proc = _python([
        "-m", "chiaroscuro_tpu_torch", "scenes/cornell.rtc", "no-preview",
        "xres", "8", "yres", "8",
    ])
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "platform cpu" in proc.stderr
    assert "Render succesfully saved" not in proc.stdout
