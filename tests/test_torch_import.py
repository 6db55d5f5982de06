"""The port imports torch and numpy only: never jax, never chiaroscuro_tpu,
never the repo's ``tools/``.  Every module is imported (the port's own
``tools`` and ``parallel`` subpackages among them), and the resident visits,
the gradient entry points, the X1/X2 wrappers, the sharding, multihost and
scaling functions and the dry run by name; the ranks that
``parallel/scaling.py`` spawns are checked too.

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
from chiaroscuro_tpu_torch.parallel.sharding import (
    make_tile_mesh, render_frame_sharded, sharded_value_and_grad)
from chiaroscuro_tpu_torch.parallel.multihost import (
    export_on_process_zero, global_tile_mesh, initialize, is_process_zero)
from chiaroscuro_tpu_torch.parallel.scaling import format_report, measure_scaling, run_ranks
from chiaroscuro_tpu_torch.entry import dryrun_multichip, entry
assert "chiaroscuro_tpu_torch.tools.cull_experiments" in names
assert "chiaroscuro_tpu_torch.tools.dma_min" in names
for n in ("parallel.sharding", "parallel.multihost", "parallel.scaling", "entry"):
    assert "chiaroscuro_tpu_torch." + n in names, n
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


# Spawned ranks run this file as their ``__mp_main__`` before they take
# their work, so the finder below refuses jax in them too.
RANKS_WITHOUT_JAX = """
import sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "chiaroscuro_tpu", "tools"):
            raise ImportError("the port imported " + name)

sys.meta_path.insert(0, NoJax())

if __name__ == "__main__":
    from chiaroscuro_tpu_torch.parallel import scaling
    from chiaroscuro_tpu_torch.scene.config import RenderConfig
    cfg = RenderConfig(obj_path="builtin:cornell_box", xres=8, yres=2, samples=1, k=1,
                       intersector="dense")
    jobs = [scaling.RankJob(cfg), scaling.RankJob(cfg, fields=("kd",))]
    ranks = scaling.run_ranks(2, jobs, device="cpu")
    print(len(ranks), tuple(ranks[1][0]["frame"].shape), sorted(sys.modules).count("jax"))
"""


def test_spawned_ranks_import_without_jax(tmp_path):
    """The ranks of ``parallel/scaling.run_ranks`` (a frame and a gradient
    step on two gloo ranks) import neither jax nor the JAX package."""
    script = tmp_path / "ranks_without_jax.py"
    script.write_text(RANKS_WITHOUT_JAX)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "2 (2, 8, 3) 0", proc.stdout


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
