"""Progressive rendering with the BVH walks' work counted: ``frame.py``'s
closed loop of ``Renderer.ray_trace`` passes, for a configuration whose
route is ``intersector bvh`` (B1/B2 and the integrator's row path).

A run without a trace, or whose readers need no walk counts, is
``frame.run`` itself.  A traced run whose readers need ``"walks"`` profiles
``trace_passes`` passes as ``frame.py`` does, then renders one more pass
under the port's ``utils/profiling.counting()`` and a profiler of its own,
inside the spans ``window`` and ``record`` (as ``frame.py`` records the
cluster visits): each B1/B2 launch of that pass runs with its work counters
and records its rays, box tests and leaf tests.  After the last pass, the
recorded one included, the image is checked by ``frame.check_image``.

``counting`` is imported here, when the driver loads: a port without the
walks' counters stops at set-up, before any pass.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch
from chiaroscuro_tpu_torch.utils.profiling import counting

from benchmarks.drivers import frame
from benchmarks.harness import faults, program, trace
from benchmarks.harness.runner import Outcome


def table_bytes(bvh) -> int:
    """Bytes of the BVH tables a walk reads: nodes, leaf starts, triangles
    and the triangles' original ids."""
    return sum(x.numel() * x.element_size()
               for x in (bvh.nodes, bvh.leaf_start, bvh.tris, bvh.tri_order))


def run(ctx) -> Outcome:
    if not (ctx.trace and "walks" in ctx.needs):
        return frame.run(ctx)
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    faults.apply(ctx.faults)
    meshes, textures = program.scene_inputs(cfg)
    ctx.mark("inputs")
    scene, scene_s = program.port_scene(meshes, textures, dev)
    ctx.mark("scene")
    rcfg = program.render_config(cfg, int(tr["spp"]), ctx.seed, dev)
    from chiaroscuro_tpu_torch.render.renderer import Renderer

    quiet = contextlib.redirect_stdout(sys.stderr)
    with quiet:
        renderer = Renderer(scene, rcfg)
        ctx.mark("intersectors")
        renderer.ray_trace()                      # pass 1 warms every shape
    program.sync(dev)
    ctx.mark("warm pass")
    print(ctx.setup_parts(), file=sys.stderr)
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
    t = trace.reduce(prof.events, n)
    record = {"trace": t, "scene_s": scene_s, "accel_s": renderer.phase_seconds["intersectors"],
              "window_peak_bytes": window_peak, "units": n}
    bvh = getattr(renderer.intersectors[0], "bvh", None)
    if bvh is not None:
        with quiet, trace.profiled() as prof2, counting() as calls:
            with trace.span("window"), trace.span("record"):
                renderer.ray_trace()
        record["walks"] = {"calls": calls, "table_bytes": table_bytes(bvh),
                           "trace": trace.reduce(prof2.events, 1)}
    pixels, layers = renderer.pixels.copy(), renderer._layers
    del renderer, scene, bvh
    program.free_cuda()
    checks = frame.check_image(cfg, tr, ctx.seed, dev, meshes, textures, pixels, layers)
    failed = 0 if np.isfinite(pixels).all() else n
    return Outcome(n, failed, {"setup_s": ctx.marks["warm pass"] - ctx.t0}, record, checks,
                   program.device_info(ctx.cell.chips, max(peak, window_peak), dev), t.busy_s,
                   t.window_s, {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()})
