"""Timing and profiling (the torch counterpart of
``chiaroscuro_tpu/utils/profiling.py``).

The reference's only instrumentation is a wall-clock print per render
(``src/rayTracer.cpp:39,72-73``).  Here:

- :func:`span`: the port's named ranges on the timed path, on only while
  a ``torch.profiler`` runs (``render.pass``, ``render.replay``,
  ``render.to_host``, ``render.accumulate``, ``render.samples``,
  ``render.raygen``, ``render.bounce`` with its children
  ``render.compact``, ``render.closest`` and ``render.shadow``, and
  ``isect.closest_backward``); shading is ``render.bounce``'s self time.
  A replayed pass opens ``render.pass``, ``render.replay`` and
  ``render.to_host`` only: the ranges inside it were issued at capture;
- ``PASSES``: ``Renderer.ray_trace``'s passes by kind;
- :func:`counting`: the BVH walks' work counters, on only inside the
  context: each B1/B2 launch (``ops/bvh_cuda.py``; the plain walk on CPU
  tensors) then runs with counts and records its rays, box tests (steps)
  and leaf triangle tests.  The launches sit inside ``render.closest`` and
  ``render.shadow``;
- :func:`profile_phases`: a measured per-phase breakdown (raygen /
  closest hit / shadow / shade+control) of one rendered frame, used by
  ``Renderer.profile_phases`` and the CLI's ``profile on``.

Device work is timed by CUDA events on the card and by ``perf_counter``
on the CPU.  Useful-work accounting (active-ray counts per bounce) lives in
the integrator (``trace_paths_planar(with_stats=True)``); the renderer
prints it in its banner.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def _synchronize(x) -> None:
    """Wait for the device work behind ``x`` (a tensor or a device)."""
    device = x.device if isinstance(x, torch.Tensor) else torch.device(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# One shared no-op context: while no profiler runs a span costs a flag test
# and no allocation, where a ``record_function`` costs microseconds.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range on the torch.profiler timeline while a profiler runs
    (``torch.profiler.record_function``, a ``user_annotation`` event on the
    thread that opened it, on the device trace's clock); a shared no-op
    context otherwise.  Nothing is kept here: the profiler holds the ranges
    and writes them with its trace."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


# Renderer.ray_trace's passes by kind: "eager" (issued operator by
# operator), "captured" (recorded as a CUDA graph) and "replayed" (that
# graph launched; the pass that captures also replays, so it counts twice).
PASSES = {"captured": 0, "replayed": 0, "eager": 0}

# The open counting() context's entries; None while none is open.
_WALK_COUNTS: Optional[List[dict]] = None


@contextlib.contextmanager
def counting():
    """Count the BVH walks' work while the block runs: each B1/B2 launch
    runs with ``counts=True`` and appends one entry to the yielded list,
    ``{"kernel": "bvh_closest" | "bvh_any", "rays": R, "steps": the sum of
    its box tests, "tests": the sum of its leaf triangle tests}`` (the sums
    read back to the host, so each launch waits for its kernel).  With no
    context open the launches request no counts and nothing is kept."""
    global _WALK_COUNTS
    outer, entries = _WALK_COUNTS, []
    _WALK_COUNTS = entries
    try:
        yield entries
    finally:
        _WALK_COUNTS = outer


def walk_counts() -> Optional[List[dict]]:
    """The open :func:`counting` context's list of entries, else None."""
    return _WALK_COUNTS


def issued_ray_queries(xres: int, yres: int, spp: int, depth: int) -> float:
    """Full-width wavefront queries issued: (closest + shadow) per bounce per
    sample per pixel.  Masked/dead lanes ride along — compare with the
    integrator's useful-query stats for SIMD occupancy."""
    return float(xres) * yres * spp * depth * 2


def _seconds(fn, device: torch.device, iters: int) -> float:
    """Best of ``iters`` timed calls of ``fn`` after one warm call: CUDA
    events on the card, ``perf_counter`` on the CPU."""
    fn()
    _synchronize(device)
    best = float("inf")
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
        best = min(best, dt)
    return best


@torch.no_grad()
def profile_phases(
    scene,
    closest_fn,
    any_fn,
    eye,
    center,
    up,
    yview: float,
    xres: int,
    yres: int,
    spp: int,
    depth: int,
    seed: int = 0,
    iters: int = 2,
) -> Dict[str, float]:
    """Measured per-phase breakdown of one frame (seconds).

    The integrator interleaves its phases inside every bounce, so this
    times four separate programs over identical inputs:

    - ``raygen``: PRNG keys + AA jitter + primary directions of ``spp``
      samples;
    - ``closest``: ``depth x spp`` closest-hit queries on the primary
      wavefront (re-intersecting the same rays: the pure intersector cost);
    - ``shadow``: the same count of occlusion queries;
    - ``full``: the renderer's own ``render_samples``.

    The JAX package times raygen + queries as one program and subtracts
    raygen; here the queries run on directions made once beforehand, so
    they are timed alone and no difference of two noisy times is clamped.

    ``shade+control`` is ``full - closest - shadow - raygen`` (clamped at
    0): the integrator's sampling, shading, masking and loop overhead.  The
    decomposition is approximate — bounce rays in ``full`` are less
    coherent than the primary rays re-traced here — but every number is a
    measurement of a real program on the same shapes.
    """
    from chiaroscuro_tpu_torch.geometry.camera import (
        camera_basis,
        primary_ray_dirs_planar,
    )
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.sampling import prng

    dev = scene.device
    lu, dx, dy = (
        torch.from_numpy(np.asarray(x, np.float32)).to(dev)
        for x in camera_basis(eye, center, up, yview, xres, yres)
    )
    ys, xs = torch.meshgrid(
        torch.arange(yres, device=dev), torch.arange(xres, device=dev), indexing="ij"
    )
    px, py = xs.reshape(-1), ys.reshape(-1)
    R = px.shape[0]
    pad = (-R) % 128
    pxp = torch.cat([px, px[:1].expand(pad)])
    pyp = torch.cat([py, py[:1].expand(pad)])
    B = ((R + pad) // 128, 128)
    pixel_idx = (pyp * xres + pxp).reshape(B)
    pxf = pxp.to(torch.float32).reshape(B)
    pyf = pyp.to(torch.float32).reshape(B)
    eye_t = torch.as_tensor(np.asarray(eye, np.float32), device=dev)
    origins = eye_t[:, None, None].expand((3,) + B).contiguous()

    closest_planar, any_planar = closest_fn.planar_fn, any_fn.planar_fn

    def raygen():
        acc = torch.zeros((3,) + B, device=dev)
        for smp in range(spp):
            _, _, jx, jy = prng.raygen_streams(seed, pixel_idx, smp)
            acc = acc + primary_ray_dirs_planar(lu, dx, dy, pxf, pyf, jx, jy)
        return acc

    dirs = (raygen() / spp).contiguous()

    def closest_sweep():
        acc = torch.zeros(B, device=dev)
        for _ in range(depth * spp):
            acc = acc + closest_planar(origins, dirs).t
        return acc

    def shadow_sweep():
        tmax = torch.full(B, 1e6, device=dev)
        excl = torch.full(B, -1, dtype=torch.int32, device=dev)
        acc = torch.zeros(B, device=dev)
        for _ in range(depth * spp):
            acc = acc + any_planar(origins, dirs, tmax, excl).to(torch.float32)
        return acc

    def full():
        return render_samples(
            scene, eye, center, up, yview, xres, yres, px, py, 0, spp, seed,
            depth, (0.0, 0.0, 0.0), closest_fn, any_fn,
        )

    t_raygen = _seconds(raygen, dev, iters)
    t_closest = _seconds(closest_sweep, dev, iters)
    t_shadow = _seconds(shadow_sweep, dev, iters)
    t_full = _seconds(full, dev, iters)
    return {
        "raygen": t_raygen,
        "closest": t_closest,
        "shadow": t_shadow,
        "shade+control": max(0.0, t_full - t_closest - t_shadow - t_raygen),
        "full": t_full,
    }


def format_phase_report(phases: Dict[str, float]) -> str:
    full = max(phases.get("full", 0.0), 1e-12)
    parts = []
    for name in ("raygen", "closest", "shadow", "shade+control"):
        if name in phases:
            parts.append(
                f"{name} {phases[name] * 1e3:.1f} ms"
                f" ({100.0 * phases[name] / full:.0f}%)"
            )
    return f"phase breakdown (full {full * 1e3:.1f} ms): " + ", ".join(parts)
