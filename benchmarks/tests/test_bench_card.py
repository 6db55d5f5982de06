"""On the card: each single-card cell runs through ``benchmarks/run.py`` for
a short window and comes out correct, with every metric it owes."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
ONE_CARD = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_on_the_card(cell, traced):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark runs only on the card")
    out = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 77), "--seconds", "2", "--trace", str(traced)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    group = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in BENCH[group] if cell in m.get("workloads", [cell])}
    assert want <= set(line["metrics"]), want - set(line["metrics"])
