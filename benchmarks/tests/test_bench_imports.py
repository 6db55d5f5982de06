"""Nothing a run loads is JAX or the JAX package (whole top-level names:
``chiaroscuro_tpu_torch`` begins with ``chiaroscuro_tpu``), and the
reference loads nothing of the port."""

import os
import subprocess
import sys

from conftest import ROOT

REF_MODULES = ("benchmarks.reference.render", "benchmarks.reference.accel",
               "benchmarks.reference.scene", "benchmarks.reference.threefry",
               "benchmarks.scenes", "benchmarks.metrics.visit_replay",
               "benchmarks.metrics.bounds")


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_port():
    tops = _loaded("import sys\n" + "".join(f"import {m}\n" for m in REF_MODULES)
                   + "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert "chiaroscuro_tpu_torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "chiaroscuro_tpu"}


def test_a_run_loads_no_jax(tiny):
    bdir = tiny()
    tops = _loaded(
        "import sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmarks.harness import runner\n"
        f"rc = runner.run('cornell.frame', 5, 0.3, False, time.perf_counter(), 'cpu', (), {bdir!r})\n"
        "assert rc == 0\n"
        "print(' '.join(runner.forbidden_modules()) or 'none', "
        "' '.join({m.split('.')[0] for m in sys.modules}))")
    assert "none" in tops and "chiaroscuro_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "chiaroscuro_tpu"}


def test_a_rank_that_loads_jax_gives_no_result(tiny, tmp_path):
    """In the sharded cell the port runs in spawned ranks: a rank that loads
    a module named ``jax`` (a stub here) fails the run, with no result."""
    bdir = tiny(traffic={"progressive_1spp_4ranks": {"ranks": 2}})
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    code = ("import sys, time, torch\n"
            "torch.set_num_threads(2)\n"
            "from benchmarks.harness import runner\n"
            "if __name__ == '__main__':\n"
            "    sys.exit(runner.run('sponza262k.frame.4chips', 7, 0.3, False, time.perf_counter(),"
            f" 'cpu', ('loads:jax',), {bdir!r}))\n")
    path = tmp_path / "drive.py"
    path.write_text(code)
    out = subprocess.run([sys.executable, str(path)], cwd=ROOT, capture_output=True, text=True,
                         timeout=900, env=dict(os.environ, PYTHONPATH=f"{stub}:{ROOT}"))
    assert out.returncode != 0 and not out.stdout.strip(), out.stdout[-2000:]
    assert "rank 0: jax" in out.stderr and "rank 1: jax" in out.stderr, out.stderr[-3000:]


def test_each_run_reads_the_reference_imports(tiny):
    """A run reads the reference's sources: clean here, and a copy whose
    reference imports the port (inside a function, through a benchmark
    module) is caught."""
    from benchmarks.harness import runner

    assert runner.reference_imports(os.path.join(ROOT, "benchmarks")) == []
    bdir = tiny()
    with open(os.path.join(bdir, "harness", "leak.py"), "w") as f:
        f.write("from chiaroscuro_tpu_torch.scene import obj_loader  # noqa: F401\n")
    assert runner.reference_imports(bdir) == []
    with open(os.path.join(bdir, "reference", "accel.py"), "a") as f:
        f.write("\n\ndef _leak():\n    from benchmarks.harness import leak\n    return leak\n")
    assert runner.reference_imports(bdir) == ["chiaroscuro_tpu_torch"]


def test_the_check_compares_whole_names():
    from benchmarks.harness import runner

    assert runner.forbidden_modules(["chiaroscuro_tpu_torch", "chiaroscuro_tpu_torch.ops",
                                     "jaxtyping", "numpy"]) == []
    assert runner.forbidden_modules(["chiaroscuro_tpu.render", "jax.numpy", "jaxlib",
                                     "flax.linen"]) == ["chiaroscuro_tpu", "flax", "jax", "jaxlib"]


def test_no_card_no_result(tmp_path):
    """Without a card the command prints no result and fails."""
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "cornell.frame",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
