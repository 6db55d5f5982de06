"""A run leaves no process behind: the sharded cell's spawned ranks and
multiprocessing's resource tracker have ended, and been waited for, before
the result is printed, and an orphaned grandchild is ended as well."""

import os
import subprocess
import sys

from conftest import ROOT


def _drive(tmp_path, code, timeout=900):
    path = tmp_path / "drive.py"
    path.write_text(code)
    out = subprocess.run([sys.executable, str(path)], cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_a_sharded_run_leaves_no_process(tiny, tmp_path):
    bdir = tiny(traffic={"progressive_1spp_4ranks": {"ranks": 2}})
    lines = _drive(tmp_path, (
        "import sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmarks.harness import procs, runner\n"
        "if __name__ == '__main__':\n"
        "    procs.adopt_orphans()\n"
        "    rc = runner.run('sponza262k.frame.4chips', 11, 0.3, False, time.perf_counter(),"
        f" 'cpu', (), {bdir!r})\n"
        "    assert rc == 0\n"
        "    print('left', procs.descendants())\n"))
    assert lines[-1] == "left []", lines[-3:]


def test_orphans_are_ended_and_waited_for(tmp_path):
    lines = _drive(tmp_path, (
        "import os, subprocess\n"
        "from benchmarks.harness import procs\n"
        "assert procs.adopt_orphans()\n"
        "sh = subprocess.run(['sh', '-c', 'sleep 300 > /dev/null 2>&1 & echo $!'],"
        " capture_output=True, text=True)\n"
        "pid = int(sh.stdout)\n"
        "assert procs.descendants() == [pid]\n"
        "left = procs.end_all(grace_s=5.0)\n"
        "assert len(left) == 1 and left[0].startswith(f'{pid} sleep'), left\n"
        "print('left', procs.descendants(), os.path.exists(f'/proc/{pid}'))\n"), timeout=120)
    assert lines[-1] == "left [] False", lines
