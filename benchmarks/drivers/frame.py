"""Progressive rendering: a closed loop of ``Renderer.ray_trace`` passes at
the configuration's fixed camera, ``spp`` samples a pass, each pass averaged
into the image as the CLI and the preview do.

Set-up builds the port's scene from the frozen inputs, makes the renderer
(its intersectors) and runs the first pass, which warms every shape the
window uses.  The window then runs passes until ``--seconds`` have gone:
``pass_ms`` is the window over its passes, ``pass_ms_p95`` the 95th
percentile of the passes' own times (each pass ends with the image on the
host); a traffic file's ``metric_suffix`` names them for frames whose pass
the host sets (``pass_ms.host``).  A traced run profiles ``trace_passes`` passes instead.  After the
window the accumulated image is compared at ``check_pixels`` pixels drawn
from the seed with the reference's own render of every pass so far.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from benchmarks.harness import faults, program, trace
from benchmarks.harness.runner import Outcome
from benchmarks.reference import accel, render, scene as ref_scene


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    faults.apply(ctx.faults)
    spp = int(tr["spp"])
    meshes, textures = program.scene_inputs(cfg)
    ctx.mark("inputs")
    scene, scene_s = program.port_scene(meshes, textures, dev)
    ctx.mark("scene")
    rcfg = program.render_config(cfg, spp, ctx.seed, dev)
    from chiaroscuro_tpu_torch.render.renderer import Renderer

    quiet = contextlib.redirect_stdout(sys.stderr)
    with quiet:
        renderer = Renderer(scene, rcfg)
        ctx.mark("intersectors")
        renderer.ray_trace()                      # pass 1 warms every shape
    program.sync(dev)
    ctx.mark("warm pass")
    t_w0 = time.perf_counter()
    setup_s = t_w0 - ctx.t0
    print(ctx.setup_parts(), file=sys.stderr)
    e2e, record, busy_s, window_s, breakdown = {"setup_s": setup_s}, None, None, None, None
    if not ctx.trace:
        times = []
        with quiet:
            while True:
                a = time.perf_counter()
                renderer.ray_trace()
                b = time.perf_counter()
                times.append(b - a)
                if b - t_w0 >= ctx.seconds:
                    break
        print("pass ms: " + program.quartiles(times), file=sys.stderr)
        sfx = tr.get("metric_suffix", "")
        e2e["pass_ms" + sfx] = (b - t_w0) * 1e3 / len(times)
        e2e["pass_ms_p95" + sfx] = float(np.percentile(np.asarray(times) * 1e3, 95))
        attempted = len(times)
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    else:
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        n = int(tr["trace_passes"])
        with quiet, trace.profiled() as prof:
            with trace.span("window"):
                for _ in range(n):
                    with trace.span("pass"):
                        renderer.ray_trace()
        window_peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
        peak = max(peak, window_peak)
        t = trace.reduce(prof.events, n)
        busy_s, window_s = t.busy_s, t.window_s
        breakdown = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
        record = {"trace": t, "scene_s": scene_s, "accel_s": renderer.phase_seconds["intersectors"],
                  "window_peak_bytes": window_peak, "units": n}
        if "visits" in ctx.needs and getattr(renderer.intersectors[0], "route", None):
            from benchmarks.metrics import visit_replay

            with quiet, trace.profiled() as prof2, visit_replay.recording() as calls:
                with trace.span("window"), trace.span("record"):
                    renderer.ray_trace()
            record["visits"] = {"calls": calls, "trace": trace.reduce(prof2.events, 1)}
        attempted = n
    if record is None:
        record = {"scene_s": scene_s, "accel_s": renderer.phase_seconds["intersectors"]}
    pixels, layers = renderer.pixels.copy(), renderer._layers
    del renderer, scene
    program.free_cuda()
    checks = check_image(cfg, tr, ctx.seed, dev, meshes, textures, pixels, layers)
    failed = 0 if np.isfinite(pixels).all() else attempted
    return Outcome(attempted, failed, e2e, record, checks,
                   program.device_info(ctx.cell.chips, peak, dev), busy_s, window_s, breakdown)


def reference_image(cfg, tr, seed, dev, meshes, textures, pix, layers, dtype=torch.float32):
    """The reference's accumulated image after ``layers`` passes at the
    global pixel indices ``pix``: (P, 3) float32."""
    spp = int(tr["spp"])
    with torch.no_grad():
        rs = ref_scene.flatten(meshes, textures, dev, dtype)
        groups = accel.Groups(rs)
        cam = cfg["camera"]
        lu, dx, dy = render.camera_basis(cam["eye"], cam["center"], cam["up"], cam["yview"],
                                         int(cfg["xres"]), int(cfg["yres"]))
        samples = render.sample_radiance(
            rs, groups, (cam["eye"], lu, dx, dy), int(cfg["xres"]), pix, layers * spp, seed,
            int(cfg["k"]), cfg.get("background", (0.0, 0.0, 0.0)))
    return render.accumulate(samples, spp)


def check_image(cfg, tr, seed, dev, meshes, textures, pixels, layers):
    t = time.perf_counter()
    pix = program.check_pixels(int(cfg["xres"]) * int(cfg["yres"]), int(tr["check_pixels"]), seed)
    want = reference_image(cfg, tr, seed, dev, meshes, textures, pix, layers)
    got = pixels.reshape(-1, 3)[pix]
    print(f"reference: {len(pix)} pixels x {layers} passes in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    return program.image_checks(got, want, tr["limits"])
