"""``correct`` at tiny sizes on the CPU: a sound run of each cell is
correct; with the timed path broken underneath (each fault the cell can
have, ``benchmarks/harness/faults.py``) it is not; and the control, the
reference in bfloat16 in the program's place, fails the limits."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

FAULTS = {
    "cornell.frame": ("state_unchanged", "half_batch", "altered"),
    "sponza262k.frame": ("state_unchanged", "half_batch", "altered"),
    "sponza262k.grad": ("state_unchanged", "half_batch", "altered"),
    "sponza262k.frame.4chips": ("no_exchange",),
}
CELLS = [c for c in FAULTS
         if c in {w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]}]
CASES = [(c, f) for c in CELLS for f in ("",) + FAULTS[c]]


def _run(bdir, cell, fault, seconds=0.6):
    """The cell's run in a fresh process (faults patch the port's modules):
    (result line, stderr)."""
    code = ("import sys, time, torch\n"
            "torch.set_num_threads(2)\n"
            "from benchmarks.harness import runner\n"
            "if __name__ == '__main__':\n"
            f"    sys.exit(runner.run({cell!r}, 2 ** 32 + 9, {seconds}, False, time.perf_counter(),"
            f" 'cpu', {tuple(x for x in (fault,) if x)!r}, {bdir!r}))\n")
    path = os.path.join(os.path.dirname(bdir), "drive.py")
    with open(path, "w") as f:
        f.write(code)
    out = subprocess.run([sys.executable, path], cwd=ROOT, capture_output=True, text=True,
                         timeout=900, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("cell, fault", CASES, ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_correct_catches_each_fault(tiny, cell, fault):
    bdir = tiny(traffic={"progressive_1spp_4ranks": {"ranks": 2}})
    line, err = _run(bdir, cell, fault)
    assert line["correct"] is (not fault), (line["checks"], err[-2000:])
    names = list(line)
    assert names[-1] == "checks" and names[:5] == ["correct", "attempted", "failed", "metrics",
                                                   "device"]
    tail = [ln for ln in err.strip().splitlines() if ln.startswith("check ")]
    assert len(tail) == len(line["checks"]) and err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell", ["cornell.frame", "sponza262k.frame", "sponza262k.grad"])
def test_control_fails(tiny, cell):
    bdir = tiny()
    import torch

    from benchmarks import control
    from benchmarks.harness import spec

    torch.set_num_threads(2)
    c = spec.resolve(spec.load_json(os.path.join(os.path.dirname(bdir), "BENCHMARK.json")),
                     cell, bdir)
    readings = control.control(c, 2 ** 31 + 1, 3, "cpu")
    limits = c.traffic["limits"]
    assert any(v > limits[k] for k, v in readings.items()), readings
