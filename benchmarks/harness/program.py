"""What the drivers share: the scene inputs handed to the port, the port's
render configuration, the card's description and the comparisons that
decide ``correct``."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmarks.harness import spec
from benchmarks.harness.runner import Check
from benchmarks.scenes.mesh import Mesh


def scene_inputs(cfg: dict, bench_dir: str = spec.BENCH_DIR
                 ) -> Tuple[List[Mesh], Dict[str, np.ndarray]]:
    """The frozen meshes and textures of a configuration's ``scene`` entry,
    made by ``benchmarks/scenes/<generator>.py``'s ``inputs``."""
    return spec.scene_generator(cfg["scene"]["generator"], bench_dir).inputs(cfg["scene"])


def port_scene(meshes, textures, device):
    """The port's scene tensors of the frozen inputs: (scene, seconds of
    ``build_scene_tensors`` up to a synchronise)."""
    from chiaroscuro_tpu_torch.scene.obj_loader import Mesh as PortMesh
    from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors

    pm = [PortMesh(**{f.name: getattr(m, f.name) for f in dataclasses.fields(m)})
          for m in meshes]
    t = time.perf_counter()
    scene = build_scene_tensors(pm, textures, device=device)
    sync(device)
    return scene, time.perf_counter() - t


def render_config(cfg: dict, spp: int, seed: int, device: str):
    from chiaroscuro_tpu_torch.scene.config import RenderConfig

    cam = cfg["camera"]
    return RenderConfig(
        obj_path=cfg["name"], k=int(cfg["k"]), xres=int(cfg["xres"]), yres=int(cfg["yres"]),
        vp=tuple(cam["eye"]), la=tuple(cam["center"]), up=tuple(cam["up"]),
        yview=float(cam["yview"]), samples=int(spp), seed=int(seed),
        intersector=cfg.get("intersector", "auto"), platform=device,
        background=tuple(cfg.get("background", (0.0, 0.0, 0.0))))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_info(count: int, peak_bytes: int, device: str) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def check_pixels(n_pixels: int, count: int, seed: int) -> np.ndarray:
    """``count`` distinct global pixel indices drawn from the seed, sorted."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 0xC0FFEE])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels), replace=False))


def image_checks(got: np.ndarray, want: np.ndarray, limits: dict) -> List[Check]:
    """The accumulated image at the checked pixels against the reference's:
    ``mismatch_pct``, the share of pixels whose largest channel gap exceeds
    1e-3 of the pixel's largest reference channel (plus a floor of 1e-3 of
    the mean, so black pixels compare absolutely), and ``rel_l1_pct``, the
    summed absolute gap over the summed reference."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    floor = 1e-3 * max(float(np.abs(want).mean()), 1e-12)
    gap = np.abs(got - want).max(axis=1) / (np.abs(want).max(axis=1) + floor)
    bad = ~np.isfinite(got).all(axis=1) | (gap > 1e-3)
    rel = float(np.abs(got - want).sum() / max(float(np.abs(want).sum()), 1e-30))
    if not np.isfinite(got).all():
        rel = float("inf")
    return [Check("mismatch_pct", 100.0 * float(bad.mean()), float(limits["mismatch_pct"])),
            Check("rel_l1_pct", 100.0 * rel, float(limits["rel_l1_pct"]))]


def quartiles(seconds) -> str:
    """n, min, quartiles, p95 and max of host-clock times, in ms."""
    x = np.asarray(seconds) * 1e3
    q = np.percentile(x, [0, 25, 50, 75, 95, 100])
    return f"n {len(x)}, min {q[0]:.2f}, p25 {q[1]:.2f}, p50 {q[2]:.2f}, p75 {q[3]:.2f}, " \
           f"p95 {q[4]:.2f}, max {q[5]:.2f}"


def free_cuda() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
