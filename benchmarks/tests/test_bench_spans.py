"""The port's own spans (``render.*``, ``isect.*``: ``user_annotation``
ranges the program opens while a profiler runs) leave every per-layer
reading as it is: each reader of ``BENCHMARK.json`` reads the same value
from a trace with them and from the same trace with them stripped, on a
hand-built trace with device work and on a CPU trace of the port."""

import os

import torch
from conftest import ROOT

from benchmarks.harness import spec, trace


def _program_span(e):
    return e.get("cat") in ("user_annotation", "gpu_user_annotation") and \
        e.get("name") not in trace.SPANS


def _readings(events, units):
    t = trace.reduce(events, units)
    rec = {"trace": t, "rank_traces": [t, t], "units": units, "window_peak_bytes": 2 ** 30,
           "scene_s": 0.5, "accel_s": 0.25}
    names = [m["name"] for m in spec.load_benchmark(ROOT)["per_layer"]]
    readers = spec.metric_readers(names, os.path.join(ROOT, "benchmarks"))
    return ({n: r.read(rec) for n, r in readers.items()},
            (t.busy_s, t.window, t.top_ops(), t.idle_gaps(), [o.backward for o in t.ops]))


def _same_with_and_without_program_spans(events, units):
    stripped = [e for e in events if not _program_span(e)]
    assert len(stripped) < len(events)
    with_spans, without = _readings(events, units), _readings(stripped, units)
    assert with_spans == without
    return with_spans


def _x(name, cat, tid, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(tid, ts, corr, kernel, start, dur):
    return [_x("cudaLaunchKernel", "cuda_runtime", tid, ts, 2.0, corr),
            _x(kernel, "kernel", 7, start, dur, corr)]


def test_hand_built_trace_reads_the_same():
    """Two passes on the main thread (1) with a backward thread (2):
    program spans on both threads and on the device's timeline, launches,
    kernels of every reader's kinds, a copy and idle gaps."""
    ev = [_x("window", "user_annotation", 1, 0.0, 1000.0)]
    corr = 0
    for p, base in enumerate((10.0, 500.0)):
        ev += [_x("pass", "user_annotation", 1, base, 400.0),
               _x("render.pass", "user_annotation", 1, base + 1.0, 398.0),
               _x("render.samples", "user_annotation", 1, base + 2.0, 300.0),
               _x("render.bounce", "user_annotation", 1, base + 5.0, 200.0),
               _x("render.closest", "user_annotation", 1, base + 6.0, 50.0),
               _x("render.accumulate", "user_annotation", 1, base + 320.0, 60.0),
               _x("aten::mul", "cpu_op", 1, base + 100.0, 5.0),
               _x("isect.closest_backward", "user_annotation", 2, base + 150.0, 100.0),
               _x("render.bounce", "user_annotation", 2, base + 160.0, 40.0),
               _x("render.bounce", "gpu_user_annotation", 7, base + 20.0, 80.0)]
        for k, (tid, kernel, off, dur) in enumerate((
                (1, "void (anonymous namespace)::closest_visits_kernel<8>(float*)", 10.0, 30.0),
                (1, "void at::native::vectorized_elementwise_kernel<4>()", 45.0, 20.0),
                (1, "ncclDevKernel_AllGather_RING_LL(ncclDevComm*)", 70.0, 5.0),
                (2, "void at::native::indexing_backward_kernel_small_stride<float>()", 160.0,
                 60.0),
                (2, "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n", 230.0, 10.0),
                (1, "void (anonymous namespace)::cull_rows_kernel(int)", 250.0, 12.0))):
            corr += 1
            ev += _launch(tid, base + off - 3.0, corr, kernel, base + off, dur)
        ev.append(_x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 7, base + 300.0, 15.0))
    readings, _ = _same_with_and_without_program_spans(ev, 2)
    assert readings["isect_ms.frame"] > 0 and readings["bwd_fetch_ms.grad"] > 0
    assert 0 < readings["idle_pct.frame"] < 100


def test_port_cpu_trace_reads_the_same(tmp_path):
    """A tiny Cornell pass under the harness's spans and a checkpointed
    gradient step, both traced on the CPU."""
    from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
    from chiaroscuro_tpu_torch.render.renderer import Renderer, render_samples
    from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA as cam, cornell_box
    from chiaroscuro_tpu_torch.scene.config import RenderConfig
    from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors

    scene = build_scene_tensors(cornell_box(), device="cpu")
    cfg = RenderConfig(obj_path="test", k=2, xres=8, yres=8, vp=cam["eye"], la=cam["center"],
                       up=cam["up"], yview=cam["yview"], samples=1, seed=3, platform="cpu")
    r = Renderer(scene, cfg)
    kd = scene.kd.clone().requires_grad_(True)
    s = scene.replace(kd=kd)
    pair = make_intersectors(s, "dense")
    px = torch.arange(64) % 8
    with trace.profiled() as prof, trace.span("window"):
        with trace.span("pass"):
            r.ray_trace()
        with trace.span("step"):
            render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], 8, 8, px,
                           px.flip(0), 0, 1, 3, 2, (0.0, 0.0, 0.0), *pair,
                           checkpoint=True).sum().backward()
    names = {e.get("name") for e in prof.events if _program_span(e)}
    assert {"render.pass", "render.bounce", "isect.closest_backward"} <= names
    _same_with_and_without_program_spans(prof.events, 2)
