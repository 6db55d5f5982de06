"""Progressive rendering over several cards: the frame driver's traffic with
each pass the port's ``parallel.sharding.render_frame_sharded``.

The harness spawns one process a card (``ranks``), each joining an NCCL
group through ``parallel.multihost.initialize`` at a free localhost port.
Each pass every rank renders its contiguous slice of the pixel grid, the
slices are all-gathered, and rank 0 copies the frame to the host and
averages it into the image as ``Renderer.ray_trace`` does.  After each pass
rank 0 broadcasts whether the window goes on.  The window is timed on rank
0 between barriers; set-up (each rank's scene, intersectors and first pass)
ends at its start.  Once its window has closed each rank reports which
forbidden modules (``runner.forbidden_modules``) it holds, and the run fails
with no result where any does.  After the ranks end, this process compares
rank 0's image with the reference on card 0, as the frame driver does.
"""

from __future__ import annotations

import contextlib
import os
import queue
import socket
import sys
import time

import numpy as np
import torch

from benchmarks.drivers import frame
from benchmarks.harness import faults, program, trace
from benchmarks.harness.runner import Outcome, forbidden_modules


# Seconds a rank may take beyond the window (set-up, the traced replay).
RANK_SLACK_S = 300.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(r, n, port, cfg, tr, seed, seconds, traced, device, fault_names, q):
    try:
        q.put((r, _rank_body(r, n, port, cfg, tr, seed, seconds, traced, device, fault_names)))
    except BaseException as e:     # the parent reports it and fails the run
        q.put((r, {"error": f"{type(e).__name__}: {e}"}))
        raise


def _rank_body(r, n, port, cfg, tr, seed, seconds, traced, device, fault_names):
    import torch.distributed as dist

    faults.apply(fault_names)
    from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
    from chiaroscuro_tpu_torch.parallel import multihost, sharding

    if device == "cuda":
        torch.cuda.set_device(r)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    multihost.initialize(f"localhost:{port}", n, r, "nccl" if device == "cuda" else "gloo")
    mesh = multihost.global_tile_mesh(device="cpu" if device == "cpu" else None)
    meshes, textures = program.scene_inputs(cfg)
    scene, scene_s = program.port_scene(meshes, textures, mesh.device)
    t = time.perf_counter()
    pair = make_intersectors(scene, cfg.get("intersector", "auto"))
    program.sync(device)
    accel_s = time.perf_counter() - t
    spp, xres, yres = int(tr["spp"]), int(cfg["xres"]), int(cfg["yres"])
    cam, state = cfg["camera"], {"layers": 0, "pixels": np.zeros((yres, xres, 3), np.float32)}

    def one_pass():
        state["layers"] += 1
        L = state["layers"]
        with trace.span("pass"):
            img = sharding.render_frame_sharded(
                scene, mesh, cam["eye"], cam["center"], cam["up"], cam["yview"], xres, yres,
                spp, seed, int(cfg["k"]), cfg.get("background", (0.0, 0.0, 0.0)), *pair,
                sample_start=(L - 1) * spp)
            if r == 0:
                with trace.span("accumulate"):
                    state["pixels"] = (state["pixels"] * (L - 1) + img.cpu().numpy()) / L

    def go_on(flag: bool) -> bool:
        f = torch.tensor([int(flag)], device=mesh.device)
        dist.broadcast(f, 0)
        return bool(f.item())

    one_pass()
    program.sync(device)
    dist.barrier()
    t_w0 = time.perf_counter()
    out = {"scene_s": scene_s, "accel_s": accel_s, "t_w0": t_w0}
    if not traced:
        times = []
        while True:
            a = time.perf_counter()
            one_pass()
            b = time.perf_counter()
            times.append(b - a)
            if not go_on(b - t_w0 < seconds):
                break
        dist.barrier()
        out.update(times=times, window=time.perf_counter() - t_w0)
        out["peak"] = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    else:
        out["peak"] = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        m = int(tr["trace_passes"])
        with trace.profiled() as prof:
            with trace.span("window"):
                for _ in range(m):
                    one_pass()
                program.sync(device)
        out["window_peak"] = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        out["trace"] = trace.reduce(prof.events, m)
        out["times"] = [0.0] * m
        dist.barrier()
    if r == 0:
        out.update(pixels=state["pixels"], layers=state["layers"])
    out["forbidden"] = forbidden_modules()
    dist.destroy_process_group()
    return out


def run(ctx) -> Outcome:
    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    n = int(tr["ranks"])
    mp = torch.multiprocessing.get_context("spawn")
    q = mp.Queue()
    port = _free_port()
    procs = [mp.Process(target=_rank, args=(r, n, port, cfg, tr, ctx.seed, ctx.seconds, ctx.trace,
                                            dev, ctx.faults, q)) for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.perf_counter() + ctx.seconds + RANK_SLACK_S
    try:
        while len(results) < n and time.perf_counter() < deadline:
            try:
                r, res = q.get(timeout=5.0)
                results[r] = res
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(timeout=60)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f"rank {r}: {v['error']}" for r, v in results.items() if "error" in v]
    if len(results) < n or errors:
        raise RuntimeError("a rank failed: " + "; ".join(errors or ["no result"]))
    loaded = [f"rank {r}: {', '.join(v['forbidden'])}" for r, v in sorted(results.items())
              if v["forbidden"]]
    if loaded:
        raise RuntimeError("a rank loaded JAX or the JAX package (the benchmark measures the "
                           "port alone): " + "; ".join(loaded))
    r0 = results[0]
    setup_s = r0["t_w0"] - ctx.t0
    peak = max(v["peak"] for v in results.values())
    e2e, record, busy_s, window_s, breakdown = {"setup_s": setup_s}, None, None, None, None
    if not ctx.trace:
        print("pass ms (rank 0): " + program.quartiles(r0["times"]), file=sys.stderr)
        e2e["pass_ms"] = r0["window"] * 1e3 / len(r0["times"])
        e2e["pass_ms_p95"] = float(np.percentile(np.asarray(r0["times"]) * 1e3, 95))
    else:
        t = r0["trace"]
        peak = max(peak, max(v["window_peak"] for v in results.values()))
        busy_s = float(np.mean([v["trace"].busy_s for v in results.values()]))
        window_s = t.window_s
        breakdown = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
        record = {"trace": t, "window_peak_bytes": r0["window_peak"], "ranks": n,
                  "rank_traces": [results[r]["trace"] for r in range(n)]}
    record = dict(record or {}, scene_s=r0["scene_s"], accel_s=r0["accel_s"])
    pixels = r0["pixels"]
    meshes, textures = program.scene_inputs(cfg)
    with contextlib.redirect_stdout(sys.stderr):
        checks = frame.check_image(cfg, tr, ctx.seed, dev, meshes, textures, pixels, r0["layers"])
    attempted = len(r0["times"])
    failed = 0 if np.isfinite(pixels).all() else attempted
    return Outcome(attempted, failed, e2e, record, checks,
                   program.device_info(ctx.cell.chips, peak, dev), busy_s, window_s, breakdown)
