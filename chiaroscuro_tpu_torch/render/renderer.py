"""Renderer: sample loops + progressive-accumulation API (torch port of
``chiaroscuro_tpu/render/renderer.py``).

``render_samples`` returns the Monte-Carlo mean radiance per pixel of a tile
over a sample range.  :class:`Renderer` mirrors the reference ``RayTracer``
surface (``include/rayTracer.hpp:10-27``): ``ray_trace(eye, center, up,
yview)`` with progressive layer averaging on an unchanged camera
(``src/rayTracer.cpp:18-33,64``), ``max_val``, ``normalize_image`` and
``export_image``.  Divergences from the reference, as in the JAX package:

- layers are seeded deterministically (disjoint sample ranges) instead of
  the reference's entropy reseed per render (``rayTracer.cpp:54``);
- the reference's ``lastUp == lastUp`` self-comparison bug (up changes never
  reset accumulation, ``rayTracer.cpp:24``) is reproduced for parity.

``render_samples`` and ``render_image`` are differentiable with respect to
the scene's fields: substitute leaf tensors that require grad with
``SceneTensors.replace`` and build the intersectors from that scene
(``make_intersectors``; the cluster path takes prebuilt ``clusters``), as
``bench.py``'s losses do with ``dataclasses.replace``.
``render_samples(checkpoint=True)`` is the counterpart of ``remat=True``.
:class:`Renderer` serves frames under ``torch.no_grad()``, so its memory
does not depend on autograd.  ``Renderer.save_state``/``load_state`` make a
progressive render resumable (``utils/checkpoint.py``; the file format is
the JAX package's, so either package resumes the other's), and
``Renderer.profile_phases`` breaks one frame down by phase
(``utils/profiling.py``).  While a torch.profiler runs, a pass opens the
spans ``render.pass`` (``render.to_host``, ``render.accumulate``) and
``render_samples`` opens ``render.samples`` and each sample's
``render.raygen`` (``utils/profiling.span``; no-ops otherwise).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.geometry import planar as P
from chiaroscuro_tpu_torch.geometry.camera import (
    camera_basis,
    primary_ray_dirs_planar,
)
from chiaroscuro_tpu_torch.render import image_io, tonemap
from chiaroscuro_tpu_torch.render.integrator import trace_paths_planar
from chiaroscuro_tpu_torch.sampling import prng
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import SceneTensors
from chiaroscuro_tpu_torch.utils.checkpoint import AccumulationState
from chiaroscuro_tpu_torch.utils.profiling import span


def render_samples(
    scene: SceneTensors,
    eye,
    center,
    up,
    yview,
    xres: int,
    yres: int,
    px: torch.Tensor,          # (R,) integer pixel columns of this tile
    py: torch.Tensor,          # (R,) integer pixel rows of this tile
    sample_start: int,         # first sample index
    n_samples: int,            # number of samples to average
    seed: int,
    depth: int,                # max path depth (scene.k)
    background,
    closest_fn,
    any_fn,
    with_stats: bool = False,
    compact: Optional[bool] = None,
    checkpoint: bool = False,
    spp_batch: int = 1,
):
    """Mean radiance over samples [sample_start, sample_start+n_samples) for
    each pixel of the tile.  Returns (R, 3) float32 (and the (depth, 2)
    int64 useful-query counts summed over samples with ``with_stats``).

    Every sample's randomness is keyed on the global (pixel index, sample
    index), so the result does not depend on tiling or sample chunking.
    Samples run one wavefront at a time, so memory does not grow with spp,
    unless ``spp_batch`` > 1:

    ``spp_batch`` folds that many samples into one wavefront (the tile
    replicated, replica r at sample index s + r), so each bounce makes one
    query of spp_batch x the rows instead of spp_batch queries: for small
    scenes the per-launch and per-op costs dominate, and batching amortizes
    them.  Each (pixel, sample) pair keeps its exact PRNG stream, so only
    the order of the float sums differs.  Ignored unless it divides
    ``n_samples``; memory grows with it.

    ``compact=None`` takes the intersector's ``prefers_compaction`` (the
    cluster path at K >= 1024): bounce compaction frees work only where
    dead rows cut intersector cost.  Radiance is bitwise the same either
    way (``trace_paths_planar``).

    Differentiable with respect to the scene's fields and the intersectors'
    buffers derived from them (see the module docstring).
    ``checkpoint=True`` runs each sample under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, the
    counterpart of the JAX ``remat=True``: backward then keeps only each
    sample's inputs and recomputes its bounces, so memory is O(pixels)
    rather than O(pixels x spp); the gradients are the same.
    """
    with span("render.samples"):
        if compact is None:
            compact = bool(getattr(closest_fn, "prefers_compaction", False))
        dev = scene.device
        left_upper, dx, dy = (
            torch.from_numpy(np.asarray(x, np.float32)).to(dev)
            for x in camera_basis(eye, center, up, yview, xres, yres)
        )
        background = torch.as_tensor(
            np.asarray(background, np.float32), device=dev
        )

        # Pad the tile to whole 128-lane rows with replicas of pixel 0; the
        # replicas are sliced off at the end.
        R = px.shape[0]
        pad = (-R) % 128
        if pad:
            px = torch.cat([px, px[:1].expand(pad)])
            py = torch.cat([py, py[:1].expand(pad)])
        Rp = R + pad
        SB = spp_batch if (spp_batch > 1 and n_samples % spp_batch == 0) else 1
        B = (Rp * SB // 128, 128)
        rep = 0
        if SB > 1:
            # Replicate the tile SB times; replica r advances the sample index
            # by r, so one wavefront carries SB consecutive samples per pixel.
            px, py = px.repeat(SB), py.repeat(SB)
            rep = torch.arange(SB, device=px.device).repeat_interleave(Rp).reshape(B)
        pixel_idx = (py.long() * xres + px.long()).reshape(B)
        pxf = px.to(torch.float32).reshape(B)
        pyf = py.to(torch.float32).reshape(B)
        eye_t = torch.as_tensor(np.asarray(eye, np.float32), device=dev)
        origins = eye_t[:, None, None].expand((3,) + B).contiguous()

        def one_sample(s):
            with span("render.raygen"):
                k0, k1 = prng.base_key(seed, pixel_idx, s + rep)
                jx, jy = prng.aa_jitter_pair(k0, k1)
                dirs = primary_ray_dirs_planar(
                    left_upper, dx, dy, pxf, pyf, jx, jy
                )
            return trace_paths_planar(
                scene, origins, dirs, k0, k1, depth, background,
                closest_fn, any_fn, with_stats=True, compact=compact,
            )

        total = torch.zeros((3,) + B, dtype=torch.float32, device=dev)
        stats = torch.zeros((depth, 2), dtype=torch.int64, device=dev)
        for s in range(sample_start, sample_start + n_samples, SB):
            if checkpoint:
                radiance, st = torch.utils.checkpoint.checkpoint(
                    one_sample, s, use_reentrant=False
                )
            else:
                radiance, st = one_sample(s)
            total = total + radiance
            stats = stats + st
        rows = P.to_rows(total)
        if SB > 1:
            rows = rows.reshape(SB, Rp, 3).sum(dim=0)
        img = rows[:R] * (1.0 / n_samples)
        if with_stats:
            return img, stats
        return img


def _render_frame(
    scene, eye, center, up, yview, xres, yres, sample_start, n_samples,
    seed, depth, background, closest_fn, any_fn,
):
    ys, xs = torch.meshgrid(
        torch.arange(yres, dtype=torch.int32, device=scene.device),
        torch.arange(xres, dtype=torch.int32, device=scene.device),
        indexing="ij",
    )
    flat, stats = render_samples(
        scene, eye, center, up, yview, xres, yres,
        xs.reshape(-1), ys.reshape(-1), sample_start, n_samples,
        seed, depth, background, closest_fn, any_fn, with_stats=True,
    )
    return flat.reshape(yres, xres, 3), stats


def render_image(
    scene: SceneTensors,
    cfg: RenderConfig,
    eye=None,
    center=None,
    up=None,
    yview: Optional[float] = None,
    sample_start: int = 0,
    n_samples: Optional[int] = None,
    intersectors: Optional[Tuple] = None,
    with_stats: bool = False,
):
    """Render a full frame (yres, xres, 3) with the config's camera/settings,
    in chunks of ``cfg.spp_chunk`` samples (0 = all at once).

    ``with_stats=True`` additionally returns the (depth, 2) useful-query
    counts (active closest / shadow queries, summed over all samples)."""
    closest_fn, any_fn = intersectors or make_intersectors(scene, cfg.intersector)
    n_samples = cfg.samples if n_samples is None else n_samples
    spc = cfg.spp_chunk if cfg.spp_chunk > 0 else n_samples

    total = None
    stats_total = None
    done = 0
    while done < n_samples:
        step = min(spc, n_samples - done)
        img, stats = _render_frame(
            scene,
            eye if eye is not None else cfg.vp,
            center if center is not None else cfg.la,
            up if up is not None else cfg.up,
            cfg.yview if yview is None else yview,
            cfg.xres,
            cfg.yres,
            sample_start + done,
            step,
            cfg.seed,
            cfg.k,
            cfg.background,
            closest_fn,
            any_fn,
        )
        total = img * step if total is None else total + img * step
        stats_total = stats if stats_total is None else stats_total + stats
        done += step
    img = total * (1.0 / n_samples)
    if with_stats:
        return img, stats_total
    return img


class Renderer:
    """Progressive path-tracing renderer with the reference's accumulation
    semantics (``src/rayTracer.cpp:17-74``)."""

    def __init__(self, scene: SceneTensors, cfg: RenderConfig):
        self.scene = scene
        self.cfg = cfg
        t0 = time.perf_counter()
        self.intersectors = make_intersectors(scene, cfg.intersector)
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
        # Set-up seconds by phase; the CLI adds "scene" and "export".
        self.phase_seconds = {"intersectors": time.perf_counter() - t0}
        self.pixels = np.zeros((cfg.yres, cfg.xres, 3), np.float32)
        self.max_val = 0.0
        self._layers = 0
        self._last_cam: Optional[Tuple] = None
        self.last_stats: Optional[dict] = None

    @torch.no_grad()
    def ray_trace(self, eye=None, center=None, up=None, yview=None) -> np.ndarray:
        """One render pass; same-camera passes average progressively (under
        ``torch.no_grad()``: serving builds no autograd graph)."""
        with span("render.pass"):
            cfg = self.cfg
            eye = tuple(np.asarray(eye if eye is not None else cfg.vp, np.float32))
            center = tuple(
                np.asarray(center if center is not None else cfg.la, np.float32)
            )
            up = tuple(np.asarray(up if up is not None else cfg.up, np.float32))
            yview = float(cfg.yview if yview is None else yview)

            # Camera-change detection incl. the reference's lastUp==lastUp quirk
            # (rayTracer.cpp:24): `up` intentionally NOT compared.
            cam_key = (eye, center, yview)
            if self._last_cam == cam_key:
                self._layers += 1
            else:
                self._layers = 1
                self._last_cam = cam_key

            dev = self.scene.device
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            print(
                f"Camera at {eye} facing: {center} with up: {up} and yview: {yview}\n"
                f"Rendering image of size {cfg.xres}x{cfg.yres} with "
                f"{self._layers * cfg.samples} samples, using "
                f"1 device(s) ({dev}: {name})...", end="\t", flush=True,
            )
            t0 = time.perf_counter()
            # Layer i consumes the disjoint sample range [(i-1)*spp, i*spp), so
            # running-averaging N layers is *exactly* a single N*spp-sample render.
            img, stats = render_image(
                self.scene,
                cfg,
                eye=eye,
                center=center,
                up=up,
                yview=yview,
                sample_start=(self._layers - 1) * cfg.samples,
                n_samples=cfg.samples,
                intersectors=self.intersectors,
                with_stats=True,
            )
            with span("render.to_host"):
                img = img.cpu().numpy()   # waits for the device
                stats = stats.cpu().numpy()
            with span("render.accumulate"):
                self.pixels = (self.pixels * (self._layers - 1) + img) / self._layers
                self.max_val = float(self.pixels.max(initial=0.0))
                dt = time.perf_counter() - t0
                # Useful-work accounting: the wavefront issues full-width queries
                # every bounce; `stats` counts the lanes whose result is consumed.
                issued = 2.0 * cfg.xres * cfg.yres * cfg.samples * cfg.k
                useful = float(stats.sum())
                self.last_stats = {
                    "seconds": dt,
                    "queries_issued": issued,
                    "queries_useful": useful,
                    "occupancy": useful / max(issued, 1.0),
                    "useful_rays_per_sec": useful / max(dt, 1e-12),
                    "per_bounce_active": stats[:, 0].tolist(),
                    "per_bounce_hit": stats[:, 1].tolist(),
                }
                print(
                    f"took {dt:.3f} seconds. "
                    f"[{useful / max(dt, 1e-12) / 1e6:.1f} Mray/s useful, "
                    f"{issued / max(dt, 1e-12) / 1e6:.1f} Mray/s issued, "
                    f"occupancy {100.0 * useful / max(issued, 1.0):.0f}%]"
                )
            return self.pixels

    def profile_phases(self, spp: Optional[int] = None) -> dict:
        """Measured per-phase breakdown of one frame at the config camera
        (see ``utils/profiling.profile_phases``); prints and returns it."""
        from chiaroscuro_tpu_torch.utils import profiling

        cfg = self.cfg
        phases = profiling.profile_phases(
            self.scene, *self.intersectors,
            cfg.vp, cfg.la, cfg.up, cfg.yview,
            cfg.xres, cfg.yres,
            min(cfg.samples, 16) if spp is None else spp, cfg.k,
            seed=cfg.seed,
        )
        print(profiling.format_phase_report(phases))
        return phases

    def normalize_image(self, exposure: Optional[float] = None) -> np.ndarray:
        """Tone-mapped uint8 image (``rayTracer.cpp:198-223``)."""
        e = self.cfg.exposure if exposure is None else exposure
        return tonemap.normalize_image(self.pixels, e)

    # --- durable progressive accumulation (utils/checkpoint.py) -----------
    # The reference loses its in-memory layer accumulation on exit
    # (rayTracer.cpp:18-33); these make long renders resumable.

    def save_state(self, path: str) -> None:
        cam = self._last_cam or (tuple(self.cfg.vp), tuple(self.cfg.la), self.cfg.yview)
        state = AccumulationState(
            pixel_sum=self.pixels.astype(np.float64) * self._layers,
            layers=self._layers,
            samples_per_layer=self.cfg.samples,
            camera=(cam[0], cam[1], tuple(self.cfg.up), cam[2]),
            seed=self.cfg.seed,
        )
        state.save(path)

    def load_state(self, path: str) -> bool:
        """Restore accumulation if compatible; returns True on resume."""
        if not os.path.exists(path):
            return False
        state = AccumulationState.load(path)
        if state.pixel_sum.shape != (self.cfg.yres, self.cfg.xres, 3):
            return False
        if state.samples_per_layer != self.cfg.samples or state.seed != self.cfg.seed:
            return False
        self.pixels = state.pixels
        self._layers = state.layers
        self._last_cam = (state.camera[0], state.camera[1], state.camera[3])
        self.max_val = float(self.pixels.max(initial=0.0))
        return True

    def export_image(self, path: Optional[str] = None) -> None:
        image_io.write_image(
            path or self.cfg.render_path, self.pixels, self.cfg.exposure
        )
