"""The traced window: torch.profiler over the harness's own spans, reduced
from its Chrome trace to device operations, busy time and idle gaps.

Spans are ``torch.profiler.record_function`` ranges that the harness opens
around its calls into the program (``pass``, ``step``, ``update``, ...); they
land in the trace on the host's timeline, beside the program's operators and
the device's kernels.  A kernel counts as the backward's where the runtime
call that launched it ran on another host thread than the harness's spans
(torch runs backward on its own thread for CUDA tensors).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float      # microseconds on the trace's clock
    dur: float
    cat: str
    backward: bool


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]
    window: Tuple[float, float]                     # the "window" span, us
    spans: List[Tuple[str, float, float]]           # harness spans
    host_ops: List[Tuple[str, float, float]]        # the main thread's operators
    units: int                                      # passes or steps traced

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def in_window(self) -> List[DeviceOp]:
        w0, w1 = self.window
        return [o for o in self.ops if o.start + o.dur > w0 and o.start < w1]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals in the window."""
        w0, w1 = self.window
        ivs = sorted((max(o.start, w0), min(o.start + o.dur, w1)) for o in self.in_window())
        out: List[Tuple[float, float]] = []
        for a, b in ivs:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_ms(self, pred) -> float:
        """Device milliseconds in the window of the kernels ``pred`` takes
        (``pred(op) -> bool``)."""
        return sum(o.dur for o in self.in_window() if o.cat == "kernel" and pred(o)) * 1e-3

    def per_unit_ms(self, pred) -> Optional[float]:
        return self.kernel_ms(pred) / self.units if self.units else None

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for o in self.in_window():
            key = short_name(o.name)
            tot[key] = tot.get(key, 0.0) + o.dur * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches of the window with nothing on the
        device, each named by the innermost harness span and program
        operator the host was in at its middle."""
        w0, w1 = self.window
        gaps, t = [], w0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < w1:
            gaps.append((t, w1))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            span = _innermost(self.spans, mid) or "window"
            op = _innermost(self.host_ops, mid) or "python"
            out.append([f"{span}/{op}", (b - a) * 1e-6])
        return out


def _innermost(events, t):
    best = None
    for name, s, e in events:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else None


def short_name(name: str) -> str:
    """A kernel's name without its return type and template arguments."""
    n = name[5:] if name.startswith("void ") else name
    cut = min((i for i in (n.find("<"), n.find("(")) if i > 0), default=len(n))
    return n[:cut][:96]


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block: yields a holder whose ``trace`` is
    filled (:func:`reduce`) when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Profiled", (), {})()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield holder
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.events = json.load(f).get("traceEvents", [])


SPANS = ("window", "pass", "step", "update", "accumulate", "record")


def reduce(events: list, units: int) -> Trace:
    """A :class:`Trace` from Chrome-trace events; the window is the
    harness's ``window`` span."""
    spans, host, launch_tid, window, main_tid = [], [], {}, None, None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat == "user_annotation" and name in SPANS:
            spans.append((name, ts, ts + dur))
            main_tid = e.get("tid")
            if name == "window":
                window = (ts, ts + dur)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_tid[corr] = e.get("tid")
    if window is None:
        raise ValueError("the trace holds no 'window' span")
    ops = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "cpu_op" and e.get("tid") == main_tid:
            ts = float(e["ts"])
            host.append((e.get("name", ""), ts, ts + float(e.get("dur", 0.0))))
        elif cat in DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            tid = launch_tid.get(corr)
            ops.append(DeviceOp(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)), cat,
                                tid is not None and main_tid is not None and tid != main_tid))
    return Trace(ops, window, spans, host, units)


def span(name: str):
    return torch.profiler.record_function(name)
