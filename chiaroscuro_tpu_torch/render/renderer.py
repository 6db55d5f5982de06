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
(``utils/profiling.py``).  ``Renderer`` keeps the running mean on the
scene's device and, on the card, replays a pass as one CUDA graph where it
can (its docstring).  While a torch.profiler runs, a pass opens the spans
``render.pass`` (``render.replay`` on a replay, ``render.to_host``,
``render.accumulate``) and ``render_samples`` opens ``render.samples`` and
each sample's ``render.raygen`` (``utils/profiling.span``; no-ops
otherwise); a replay opens none of those inside the graph.
"""

from __future__ import annotations

import contextlib
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
from chiaroscuro_tpu_torch.utils import profiling
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
    camera: Optional[Tuple[torch.Tensor, ...]] = None,
):
    """Mean radiance over samples [sample_start, sample_start+n_samples) for
    each pixel of the tile.  Returns (R, 3) float32 (and the (depth, 2)
    int64 useful-query counts summed over samples with ``with_stats``).

    ``sample_start`` may be a 0-dim int64 tensor on the scene's device,
    ``background`` a (3,) float32 tensor there, and ``camera`` the
    (eye, left_upper, dx, dy) tensors of :func:`camera_tensors`, which then
    stand in for ``eye, center, up, yview``.  So given, a call copies
    nothing from the host and can be captured as a CUDA graph
    (:class:`Renderer`); the radiance is bitwise that of the Python values.

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
        if camera is None:
            camera = camera_tensors(eye, center, up, yview, xres, yres, dev)
        eye_t, left_upper, dx, dy = camera
        if not isinstance(background, torch.Tensor):
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
        origins = eye_t[:, None, None].expand((3,) + B).contiguous()

        def one_sample(s):
            with span("render.raygen"):
                k0, k1, jx, jy = prng.raygen_streams(seed, pixel_idx, s + rep)
                dirs = primary_ray_dirs_planar(
                    left_upper, dx, dy, pxf, pyf, jx, jy
                )
            return trace_paths_planar(
                scene, origins, dirs, k0, k1, depth, background,
                closest_fn, any_fn, with_stats=True, compact=compact,
            )

        total = torch.zeros((3,) + B, dtype=torch.float32, device=dev)
        stats = torch.zeros((depth, 2), dtype=torch.int64, device=dev)
        for i in range(0, n_samples, SB):
            s = sample_start + i
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


def camera_tensors(eye, center, up, yview, xres: int, yres: int, device):
    """(eye, left_upper, dx, dy): the camera as (3,) float32 tensors on
    ``device`` (:func:`~chiaroscuro_tpu_torch.geometry.camera.camera_basis`),
    as :func:`render_samples` takes them."""
    return tuple(
        torch.from_numpy(np.asarray(x, np.float32)).to(device)
        for x in (eye, *camera_basis(eye, center, up, yview, xres, yres))
    )


def _render_frame(
    scene, eye, center, up, yview, xres, yres, sample_start, n_samples,
    seed, depth, background, closest_fn, any_fn, camera=None,
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
        camera=camera,
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
    camera: Optional[Tuple[torch.Tensor, ...]] = None,
    background=None,
):
    """Render a full frame (yres, xres, 3) with the config's camera/settings,
    in chunks of ``cfg.spp_chunk`` samples (0 = all at once).

    ``with_stats=True`` additionally returns the (depth, 2) useful-query
    counts (active closest / shadow queries, summed over all samples).
    ``sample_start``, ``camera`` and ``background`` (in place of
    ``cfg.background``) may be tensors on the scene's device, as
    :func:`render_samples` takes them."""
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
            cfg.background if background is None else background,
            closest_fn,
            any_fn,
            camera,
        )
        total = img * step if total is None else total + img * step
        stats_total = stats if stats_total is None else stats_total + stats
        done += step
    img = total * (1.0 / n_samples)
    if with_stats:
        return img, stats_total
    return img


def running_mean_(image, layer, weights):
    """``image <- (image * (L - 1) + layer) / L`` in place, ``weights`` the
    (2,) float32 (L - 1, L) on ``image``'s device; returns the new image's
    maximum floored at 0 (a 0-dim tensor; NaN wherever numpy's
    ``max(initial=0.0)`` gives it).  Three rounded operations with a tensor
    divisor, so the image is bitwise numpy's ``(p * (L - 1) + img) / L``
    (ATen's CUDA division by a host scalar multiplies by its reciprocal)."""
    torch.div(image * weights[0] + layer, weights[1], out=image)
    return torch.clamp_min(image.amax(), 0.0)


class _CapturedPass:
    """One pass recorded as a CUDA graph, with what its replay reads back."""

    def __init__(self, graph, stats, max_val):
        self.graph = graph
        self.stats = stats
        self.max_val = max_val


def _same_pass(a, b) -> bool:
    """Whether two pass keys (:meth:`Renderer._card_pass`) name one graph:
    equal shapes and seed, and the very same scene and pair objects."""
    return b is not None and a[0] == b[0] and all(x is y for x, y in zip(a[1], b[1]))


def _capturable(fn) -> bool:
    """The intersector's own answer (its ``.capturable()``); False where it
    declares none."""
    ask = getattr(fn, "capturable", None)
    return ask is not None and ask()


class _CardPasses:
    """The state of a :class:`Renderer`'s passes: the running mean in an
    image on the scene's device, the pass's inputs in one static buffer,
    the last pass's key, the pass captured at that key, and (on the card)
    the stream every pass runs on.

    The buffer holds, as int32 words, the first sample index (int64), then
    eye, left_upper, dx, dy, the background and (L - 1, L) as float32; it is
    written before each pass, so one graph serves every camera and layer.

    Eager passes run on the stream the graph is captured on, so the first
    eager pass warms what a capture cannot record: the persistent kernels'
    work counters and cuBLAS's workspace, allocated on a stream's first
    launch.  A graph's kernels keep that stream's counters, which holds
    while no launch on the stream overlaps a replay: every pass is issued
    there in order."""

    _WORDS = 2 + 17

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.inputs = torch.zeros(self._WORDS, dtype=torch.int32, device=device)
        f = self.inputs[2:].view(torch.float32)
        self.start = self.inputs[:2].view(torch.int64)[0]
        self.camera = (f[0:3], f[3:6], f[6:9], f[9:12])
        self.background = f[12:15]
        self.weights = f[15:17]
        self.image: Optional[torch.Tensor] = None
        self.handed: Optional[np.ndarray] = None   # the last pixels handed out
        self.last_key = None
        self.captured: Optional[_CapturedPass] = None   # at last_key

    def load(self, pixels: np.ndarray, start: int, camera, background, layers: int):
        """Write the pass's inputs (``camera`` = (eye, left_upper, dx, dy),
        host vectors); re-seed the device image from
        ``pixels`` where they are not the array the last pass handed out
        (the first pass, ``load_state``, or an assignment)."""
        host = np.empty(self._WORDS, np.int32)
        host[:2] = np.array([start], np.int64).view(np.int32)
        host[2:] = np.concatenate(
            [np.asarray(x, np.float32).reshape(-1)
             for x in (*camera, background, (layers - 1, layers))]
        ).view(np.int32)
        self.inputs.copy_(torch.from_numpy(host))
        if pixels is not self.handed:
            if self.image is None or tuple(self.image.shape) != pixels.shape:
                self.image = torch.empty(pixels.shape, dtype=torch.float32,
                                         device=self.inputs.device)
                self.captured = None
            self.image.copy_(torch.from_numpy(np.asarray(pixels, np.float32)))

    @contextlib.contextmanager
    def on_stream(self):
        """Make the passes' stream current, after the caller's stream's work
        and before its next (a no-op on CPU tensors)."""
        if self.stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield
        caller.wait_stream(self.stream)


class Renderer:
    """Progressive path-tracing renderer with the reference's accumulation
    semantics (``src/rayTracer.cpp:17-74``).

    The running mean lives in an image on the scene's device (CPU tensors
    take the same path), and on the card a pass is replayed as one captured
    CUDA graph (the wavefront of every sample, the mean and its maximum)
    where both of these hold: the pair answers ``capturable()`` True (its
    launches neither synchronise nor read back: the dense pair always, the
    BVH pair outside ``utils/profiling.counting()``; the cluster pair
    declares nothing), and the previous pass had the same shapes, seed,
    scene and pair.  The camera, the first sample index and the layer
    count are the graph's inputs, so any camera replays.  A replay runs the
    eager pass's kernels in its order on its operands, so its image is
    bitwise the eager pass's; the intersectors' ``LAUNCHES`` do not advance
    on a replay (``utils/profiling.PASSES`` counts passes by kind)."""

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
        self._card = _CardPasses(scene.device)

    @torch.no_grad()
    def ray_trace(self, eye=None, center=None, up=None, yview=None) -> np.ndarray:
        """One render pass; same-camera passes average progressively (under
        ``torch.no_grad()``: serving builds no autograd graph).  Returns
        ``self.pixels``, a new array each pass."""
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
            replayed, stats = self._card_pass(
                (self._layers - 1) * cfg.samples,
                (eye, *camera_basis(eye, center, up, yview, cfg.xres, cfg.yres)),
            )
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
                "replayed": replayed,
            }
            print(
                f"took {dt:.3f} seconds. "
                f"[{useful / max(dt, 1e-12) / 1e6:.1f} Mray/s useful, "
                f"{issued / max(dt, 1e-12) / 1e6:.1f} Mray/s issued, "
                f"occupancy {100.0 * useful / max(issued, 1.0):.0f}%]"
            )
            return self.pixels

    def _card_pass(self, start: int, camera):
        """The pass, eager or replayed (the class docstring), at ``camera`` =
        (eye, left_upper, dx, dy); sets ``pixels`` and ``max_val``, returns
        (replayed, stats).

        The key holds the scene and the pair themselves, so the tables a
        graph reads live as long as it does; a pass with another key drops
        the graph and runs eagerly."""
        cfg, card = self.cfg, self._card
        closest_fn, any_fn = self.intersectors
        key = ((cfg.xres, cfg.yres, cfg.samples, cfg.spp_chunk, cfg.k, cfg.seed),
               (self.scene, closest_fn, any_fn))
        replayed = _same_pass(key, card.last_key)
        if not replayed:
            card.captured = None
        card.last_key = key
        replayed = (replayed and card.stream is not None
                    and _capturable(closest_fn) and _capturable(any_fn))
        with card.on_stream():
            card.load(self.pixels, start, camera, cfg.background, self._layers)
            if replayed:
                if card.captured is None:
                    self._capture()
                with span("render.replay"):
                    card.captured.graph.replay()
                stats, max_val = card.captured.stats, card.captured.max_val
                profiling.PASSES["replayed"] += 1
            else:
                stats, max_val = self._pass_on_card()
                profiling.PASSES["eager"] += 1
            with span("render.to_host"):
                self.pixels = card.handed = card.image.to("cpu", copy=True).numpy()
                self.max_val = float(max_val.item())
                return replayed, stats.cpu().numpy()

    def _pass_on_card(self):
        """The wavefront from the static inputs and the running mean:
        (stats, max_val) tensors."""
        card = self._card
        img, stats = render_image(
            self.scene, self.cfg, sample_start=card.start, n_samples=self.cfg.samples,
            intersectors=self.intersectors, with_stats=True, camera=card.camera,
            background=card.background,
        )
        with span("render.accumulate"):
            return stats, running_mean_(card.image, img, card.weights)

    def _capture(self) -> None:
        """Record the pass as a CUDA graph on the passes' stream (the eager
        pass at the same key warmed it)."""
        card = self._card
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=card.stream):
            stats, max_val = self._pass_on_card()
        card.captured = _CapturedPass(graph, stats, max_val)
        profiling.PASSES["captured"] += 1

    def profile_phases(self, spp: Optional[int] = None) -> dict:
        """Measured per-phase breakdown of one frame at the config camera
        (see ``utils/profiling.profile_phases``); prints and returns it."""
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
