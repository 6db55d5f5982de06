"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``benchmarks/configs/<config>.json``) and a
traffic mix (``benchmarks/traffic/<traffic>.json``); the configuration names
its scene generator (``benchmarks/scenes/<generator>.py``), the mix its driver
(``benchmarks/drivers/<driver>.py``); each per-layer metric is read by
``benchmarks/metrics/<metric>.py``.  Nothing here knows a cell, a mix or a
metric by name, so a later change adds one by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, with its "name"
    traffic: dict         # the traffic file, with its "name"
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``bench`` with its configuration and traffic
    files read, and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = dict(load_json(os.path.join(os.path.dirname(bench_dir), configs[w["config"]]["file"])))
    cfg["name"] = w["config"]
    traffic = dict(load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")))
    traffic["name"] = w["traffic"]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    pl = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(workload, int(w["chips"]), cfg, traffic, e2e, pl)


def _load_file(path: str, module_name: str):
    mod = sys.modules.get(module_name)
    if mod is not None and os.path.abspath(getattr(mod, "__file__", "") or "") == \
            os.path.abspath(path):
        return mod
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: dict, bench_dir: str = BENCH_DIR):
    """The driver module a traffic mix names."""
    name = traffic["driver"]
    if not NAME_RE.match(name):
        raise ValueError(f"bad driver name {name!r}")
    return _load_file(os.path.join(bench_dir, "drivers", name + ".py"),
                      "benchmarks.drivers." + name)


def scene_generator(name: str, bench_dir: str = BENCH_DIR):
    """The scene module a configuration's ``scene.generator`` names."""
    if not NAME_RE.match(name) or "." in name:
        raise ValueError(f"bad scene generator name {name!r}")
    return _load_file(os.path.join(bench_dir, "scenes", name + ".py"), "benchmarks.scenes." + name)


def metric_readers(names: List[str], bench_dir: str = BENCH_DIR) -> Dict[str, object]:
    """{metric: its reader module} for the per-layer metrics ``names``."""
    out = {}
    for n in names:
        if not NAME_RE.match(n):
            raise ValueError(f"bad metric name {n!r}")
        out[n] = _load_file(os.path.join(bench_dir, "metrics", n + ".py"),
                            "benchmarks.metrics." + n.replace(".", "_").replace("-", "_"))
    return out
