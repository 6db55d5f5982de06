"""One run of one cell: resolve it, check the card, let its driver set up,
measure and check, then print the result line.

A driver module exposes ``run(ctx) -> Outcome``.  The runner never imports
the program itself; drivers do.  Once the driver returns, the runner looks
in ``sys.modules`` for JAX or the JAX package (compared by whole top-level
name: ``chiaroscuro_tpu_torch`` is the port, ``chiaroscuro_tpu`` the JAX
package) and fails the run where it finds one.  Before that it ends, and
waits for, every process the run still has (``procs.end_all``).  It also reads the sources of
the reference and of the scene inputs it is handed (``reference/``,
``scenes/`` and the benchmark modules they import) and fails the run where
any of them imports the port, JAX or the JAX package.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

from benchmarks.harness import procs, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "chiaroscuro_tpu")
PORT = "chiaroscuro_tpu_torch"
# The benchmark's packages that compute the reference or make its inputs.
REFERENCE_PACKAGES = ("reference", "scenes")


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float]                # end-to-end readings (trace 0)
    record: Optional[object]             # what per-layer readers read (trace 1)
    checks: List[Check]
    device: dict
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


@dataclasses.dataclass
class Context:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    t0: float                            # process start, perf_counter
    device: str = "cuda"                 # "cpu" only in the CPU tests
    faults: tuple = ()                   # planted faults (CPU tests)
    needs: frozenset = frozenset()       # what the cell's metric readers read beyond the trace
    marks: dict = dataclasses.field(default_factory=dict)   # set-up's clock marks

    def mark(self, name: str) -> None:
        self.marks[name] = time.perf_counter()

    def setup_parts(self) -> str:
        """The set-up's parts, seconds from each mark to the next."""
        prev, parts = self.t0, []
        for name, t in self.marks.items():
            parts.append(f"{name} {t - prev:.2f}")
            prev = t
        return "set-up parts (s): " + ", ".join(parts)


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (``sys.modules`` where
    None), compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def reference_imports(bench_dir: str) -> List[str]:
    """The port's or JAX's top-level names that the sources of
    ``REFERENCE_PACKAGES`` import, directly or through the benchmark's own
    modules they import, read with ``ast`` (imports inside functions too)."""
    root = os.path.dirname(bench_dir)
    todo = [os.path.join(bench_dir, p, f) for p in REFERENCE_PACKAGES
            for f in sorted(os.listdir(os.path.join(bench_dir, p))) if f.endswith(".py")]
    seen, bad = set(), set()
    while todo:
        path = todo.pop()
        if path in seen or not os.path.isfile(path):
            continue
        seen.add(path)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top == PORT or top in FORBIDDEN:
                    bad.add(top)
                elif top == "benchmarks":
                    base = os.path.join(root, *n.split("."))
                    todo += [base + ".py", os.path.join(base, "__init__.py")]
    return sorted(bad)


def keep_caches_in(root: str) -> None:
    """Fixed cache directories inside the checkout for anything that builds
    or compiles (the port's own libraries go to its ``_build/``)."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def _num(x):
    return float(x)


def result_line(cell: spec.Cell, out: Outcome, trace: bool, readers=None) -> dict:
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": _num(out.e2e[m["name"]]), "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = readers[m["name"]].read(out.record)
            if v is not None:
                metrics[m["name"]] = {"value": _num(v), "unit": m["unit"]}
    device = dict(out.device)
    if trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    line = {"correct": all(c.ok for c in out.checks), "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return line


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", faults: tuple = (), bench_dir: str = spec.BENCH_DIR) -> int:
    """Run the cell; print the result line last on stdout and the compared
    numbers last on stderr.  Returns the exit code."""
    root = os.path.dirname(bench_dir)
    bench = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    cell = spec.resolve(bench, workload, bench_dir)
    keep_caches_in(root)
    import torch

    marks = {"imports": time.perf_counter()}
    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs only on the card", file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"{workload} needs {cell.chips} cards, {torch.cuda.device_count()} present",
                  file=sys.stderr)
            return 3
        torch.zeros(1, device="cuda")
    marks["cuda"] = time.perf_counter()
    readers = spec.metric_readers([m["name"] for m in cell.per_layer], bench_dir) if trace else None
    drv = spec.driver(cell.traffic, bench_dir)
    needs = frozenset(n for r in (readers or {}).values() for n in getattr(r, "NEEDS", ()))
    ctx = Context(cell, int(seed), float(seconds), bool(trace), t0, device, tuple(faults), needs,
                  marks)
    out = drv.run(ctx)
    left = procs.end_all()
    if left:
        print("ended what the run left running: " + "; ".join(left), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark measures the port alone",
              file=sys.stderr)
        return 4
    bad = reference_imports(bench_dir)
    if bad:
        print(f"the reference imports {', '.join(bad)}: it has to stand apart from the port",
              file=sys.stderr)
        return 4
    line = result_line(cell, out, trace, readers)
    for c in out.checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
