"""The harness is driven by data: every cell of BENCHMARK.json resolves to
its files by name, a new configuration, traffic mix or metric is found
without an edit to any existing file, and every name and unit keeps to the
allowed characters."""

import json
import os
import re

import pytest

from benchmarks.harness import spec
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.resolve(BENCH, cell)
    assert c.config["name"] and c.traffic["name"]
    spec.driver(c.traffic)
    spec.metric_readers([m["name"] for m in c.per_layer])
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            for k in e.get("reduced", []):
                assert NAME.match(k)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    names = [e["name"] for g in ("end_to_end", "per_layer") for e in BENCH[g]]
    assert len(names) == len(set(names))
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves
        for w in m.get("workloads", CELLS):
            e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert w in e2e.get("workloads", CELLS)


def test_new_files_are_found_without_edits(tmp_path):
    """A configuration with its own scene generator, a traffic mix and a
    metric added as new files (and entries) in a copy are resolved; no
    existing file changes."""
    from conftest import tiny_copy

    bdir = tiny_copy(str(tmp_path))
    before = {p: open(p, "rb").read() for p in _files(bdir)}
    cfg = json.load(open(os.path.join(bdir, "configs", "cornell_box.json")))
    cfg["xres"] = 8
    json.dump(cfg, open(os.path.join(bdir, "configs", "cornell_small.json"), "w"))
    json.dump({"driver": "frame", "spp": 2, "trace_passes": 2, "check_pixels": 4,
               "limits": {"mismatch_pct": 1.0, "rel_l1_pct": 0.1}},
              open(os.path.join(bdir, "traffic", "progressive_2spp.json"), "w"))
    cfg["scene"] = {"generator": "one_quad"}
    json.dump(cfg, open(os.path.join(bdir, "configs", "cornell_small.json"), "w"))
    with open(os.path.join(bdir, "scenes", "one_quad.py"), "w") as f:
        f.write("from benchmarks.scenes import cornell\n\n\n"
                "def inputs(scene):\n    return cornell.cornell_box()[:1], {}\n")
    with open(os.path.join(bdir, "metrics", "launches.frame.py"), "w") as f:
        f.write("def read(rec):\n    return 1.0\n")
    bench = json.load(open(os.path.join(str(tmp_path), "BENCHMARK.json")))
    bench["configs"].append({"name": "cornell_small", "source": "x", "reduced": ["xres"],
                             "file": "benchmarks/configs/cornell_small.json", "why": "x"})
    bench["workloads"].append({"name": "cornell_small.frame", "config": "cornell_small",
                               "traffic": "progressive_2spp", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "launches.frame", "unit": "count", "better": "lower",
                               "source": "program_counter", "layer": "ops", "moves": "setup_s",
                               "workloads": ["cornell_small.frame"]})
    c = spec.resolve(bench, "cornell_small.frame", bdir)
    assert c.config["xres"] == 8 and c.traffic["spp"] == 2
    assert spec.driver(c.traffic, bdir).run
    from benchmarks.harness import program

    meshes, textures = program.scene_inputs(c.config, bdir)
    assert len(meshes) == 1 and textures == {}
    readers = spec.metric_readers([m["name"] for m in c.per_layer], bdir)
    assert readers["launches.frame"].read({}) == 1.0
    assert {p: open(p, "rb").read() for p in before} == before


def _files(d):
    return [os.path.join(a, f) for a, _, fs in os.walk(d) for f in fs if "__pycache__" not in a]
