"""Tests of the benchmark (``python -m pytest benchmarks/tests -q``).

On the CPU they run the harness at tiny sizes through the kernels' plain
versions; tests marked ``cuda`` need the card and skip without one (the
decision is taken inside each test)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

TINY = {
    "sponza_atrium_262k": {"xres": 32, "yres": 16,
                           "scene": {"generator": "atrium", "target_tris": 2200,
                                     "geometry_seed": 0}},
    "cornell_box": {"xres": 16, "yres": 16},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


def tiny_copy(dest, configs=TINY, traffic=None, intersector=None):
    """A copy of BENCHMARK.json and benchmarks/ under ``dest`` with the
    configurations cut to ``configs``' sizes (and traffic keys changed);
    returns the copy's benchmark directory."""
    shutil.copytree(os.path.join(ROOT, "benchmarks"), os.path.join(dest, "benchmarks"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    bdir = os.path.join(dest, "benchmarks")
    for name, change in configs.items():
        p = os.path.join(bdir, "configs", name + ".json")
        c = json.load(open(p))
        c.update(change)
        if intersector:
            c["intersector"] = intersector
        json.dump(c, open(p, "w"))
    for name, change in (traffic or {}).items():
        p = os.path.join(bdir, "traffic", name + ".json")
        t = json.load(open(p))
        t.update(change)
        json.dump(t, open(p, "w"))
    return bdir


@pytest.fixture
def tiny(tmp_path):
    return lambda **kw: tiny_copy(str(tmp_path), **kw)
