"""The cell ``sponza262k.frame.bvh`` on the CPU at tiny sizes: its driver
(``drivers/frame_walks.py``) records the BVH walks' counts of one more pass
in a traced run, ``walks_roofline`` reads a hand-built record and nothing
from a mismatched one, the driver stops at set-up under a port without the
walks' counters, and the planted faults fail ``correct`` for the cell."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch
from conftest import ROOT, TINY
from test_bench_correct import _run

from benchmarks.harness import runner, spec, trace
from benchmarks.metrics import bounds, walk_bounds

CELL = "sponza262k.frame.bvh"
TINY_BVH = dict(TINY, sponza_atrium_262k_bvh=TINY["sponza_atrium_262k"])


@pytest.mark.parametrize("fault", ["", "state_unchanged", "half_batch", "altered"])
def test_correct_catches_each_fault(tiny, fault):
    """A sound run of the cell is correct; each fault a frame can have
    (``harness/faults.py``) fails it.  The pass is timed under the host-bound
    frame's names."""
    line, err = _run(tiny(configs=TINY_BVH), CELL, fault)
    assert line["correct"] is (not fault), (line["checks"], err[-2000:])
    assert set(line["checks"]) == {"mismatch_pct", "rel_l1_pct"}
    assert set(line["metrics"]) == {"pass_ms.host", "pass_ms_p95.host", "setup_s"}


def test_traced_run_records_one_pass_of_walks(tiny):
    """A traced run's record holds the walks of one more pass: a closest and
    a shadow walk a bounce, each of the image's rays, and the BVH tables'
    bytes; on the CPU no kernel runs, so ``walks_roofline`` reads nothing,
    and the image, the recorded pass included, is correct."""
    bdir = tiny(configs=TINY_BVH)
    bench = spec.load_json(os.path.join(os.path.dirname(bdir), "BENCHMARK.json"))
    cell = spec.resolve(bench, CELL, bdir)
    readers = spec.metric_readers([m["name"] for m in cell.per_layer], bdir)
    assert "walks_roofline" in readers
    needs = frozenset(n for r in readers.values() for n in getattr(r, "NEEDS", ()))
    assert needs == {"walks"}
    torch.set_num_threads(2)
    ctx = runner.Context(cell, 2 ** 32 + 11, 0.1, True, 0.0, "cpu", (), needs)
    out = spec.driver(cell.traffic, bdir).run(ctx)
    walks = out.record["walks"]
    k, rays = int(cell.config["k"]), int(cell.config["xres"]) * int(cell.config["yres"])
    assert [c["kernel"] for c in walks["calls"]] == ["bvh_closest", "bvh_any"] * k
    assert {c["rays"] for c in walks["calls"]} == {rays}
    assert all(c["steps"] >= c["rays"] and c["tests"] > 0 for c in walks["calls"])
    assert walks["table_bytes"] > 0
    assert readers["walks_roofline"].read(out.record) is None
    assert all(c.ok for c in out.checks) and out.attempted == cell.traffic["trace_passes"]


def _walk_trace(durations_us):
    ops, t = [], 0.0
    for name, dur in durations_us:
        ops.append(trace.DeviceOp(f"void (anonymous namespace)::{name}(ClosestArgs, Bvh)", t, dur,
                                  "kernel", False))
        t += dur + 5.0
    ops.append(trace.DeviceOp("at::native::elementwise_kernel", t, 50.0, "kernel", False))
    return trace.Trace(ops, (0.0, t + 50.0), [], [], 1)


def test_walks_roofline_reads_a_hand_built_record():
    """Each launch's bound is the larger of its operations' and its bytes'
    time; the reading is their sum over the kernels' device time.  Nothing
    is read with no walks, a launch missing from the trace, or a kernel the
    counts do not hold."""
    read = spec.metric_readers(["walks_roofline"])["walks_roofline"].read
    calls = [{"kernel": "bvh_closest", "rays": 1000, "steps": 40_000, "tests": 90_000},
             {"kernel": "bvh_any", "rays": 1000, "steps": 30_000, "tests": 20_000}]
    table = 4_000_000
    rec = {"walks": {"calls": calls, "table_bytes": table,
                     "trace": _walk_trace([("bvh_closest_kernel", 20.0),
                                           ("bvh_any_kernel", 10.0)])}}
    ops = [25 * 40_000 + 54 * 90_000, 25 * 30_000 + 54 * 20_000]
    nbytes = [41 * 1000 + table, 33 * 1000 + table]
    bound = sum(max(o / 33.5e12, b / 3.35e12) for o, b in zip(ops, nbytes))
    assert np.isclose(read(rec), 100.0 * bound / 30e-6)
    assert np.isclose(walk_bounds.launch_bound_s(calls[0], table),
                      bounds.bound_s(ops[0], nbytes[0]))
    missing = dict(rec["walks"], trace=_walk_trace([("bvh_closest_kernel", 20.0)]))
    extra = dict(rec["walks"], trace=_walk_trace([("bvh_closest_kernel", 20.0)] * 2
                                                 + [("bvh_any_kernel", 10.0)]))
    assert read({"walks": missing}) is None and read({"walks": extra}) is None
    assert read({"walks": dict(rec["walks"], calls=[])}) is None
    assert read({"trace": rec["walks"]["trace"]}) is None


def test_driver_stops_at_setup_without_the_walks_counters(monkeypatch):
    """A port whose ``utils/profiling`` has no ``counting`` (the tree before
    the counters) cannot load the driver: the cell stops at set-up."""
    stub = types.ModuleType("chiaroscuro_tpu_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "chiaroscuro_tpu_torch.utils.profiling", stub)
    path = os.path.join(ROOT, "benchmarks", "drivers", "frame_walks.py")
    loaded = importlib.util.spec_from_file_location("frame_walks_without_counters", path)
    with pytest.raises(ImportError, match="counting"):
        loaded.loader.exec_module(importlib.util.module_from_spec(loaded))
