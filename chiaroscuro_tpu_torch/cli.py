"""CLI entry point: ``python -m chiaroscuro_tpu_torch [scene.rtc] [key value ...]``.

Mirrors ``chiaroscuro_tpu/cli.py`` (the reference's ``main.cpp:5-21`` flow):
parse the config, load the scene, construct the renderer, run the
interactive preview (``preview/viewer.py``; without a display or matplotlib
it renders one layer) or, with ``no-preview``, a one-shot batch render, and
always export the image.  ``platform`` picks the torch device:
``cuda`` (the default) or ``cpu``.  Without a CUDA device and without
``platform cpu`` the CLI raises rather than quietly rendering on the CPU.
After the render it prints the kernel launches it made and, on the cluster
path, the visit route (``resident`` K4/K5 or ``stream`` K6/K7); with
``profile on`` it then prints the frame's per-phase breakdown
(``Renderer.profile_phases``), as the JAX CLI does.
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

import torch

from chiaroscuro_tpu_torch.ops import (bvh_cuda, cluster_cuda, intersect_cuda, scatter_cuda,
                                       threefry_cuda)
from chiaroscuro_tpu_torch.render.renderer import Renderer
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import load_scene


def resolve_device(platform: str) -> torch.device:
    """The torch device for the ``platform`` setting; raises where it is
    not available."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "cuda":
        raise ValueError(f"platform must be 'cuda' or 'cpu', got {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass `platform cpu` to render on "
            "the CPU with the kernels' plain torch versions"
        )
    return torch.device("cuda", torch.cuda.current_device())


def launch_counts() -> dict:
    """Every kernel's launch count so far, keyed by kernel name."""
    return {**intersect_cuda.LAUNCHES, **cluster_cuda.LAUNCHES, **bvh_cuda.LAUNCHES,
            **scatter_cuda.LAUNCHES, **threefry_cuda.LAUNCHES}


def run(argv: Sequence[str]) -> Renderer:
    """The batch render of ``main``; returns the renderer (pixels and
    ``last_stats``)."""
    cfg = RenderConfig.from_argv(list(argv))
    device = resolve_device(cfg.platform)

    # Point-light banner parity (kdtree.cpp:99-104).
    if cfg.light_points:
        print("Point Lights in scene:")
        for lp in cfg.light_points:
            print(
                f"Position {lp.position} of color {lp.color} "
                f"and intesity {lp.intensity}"
            )
    t0 = time.perf_counter()
    scene = load_scene(cfg, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    scene_seconds = time.perf_counter() - t0
    renderer = Renderer(scene, cfg)
    renderer.phase_seconds["scene"] = scene_seconds
    before = launch_counts()
    if cfg.use_preview:
        from chiaroscuro_tpu_torch.preview.viewer import run_preview

        run_preview(renderer)
    else:
        renderer.ray_trace(cfg.vp, cfg.la, cfg.up, cfg.yview)
    launched = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    route = getattr(renderer.intersectors[0], "route", None)
    print(f"Kernel launches: {launched or 'none (plain torch versions)'}"
          + (f"; cluster route: {route}" if route else ""))
    if cfg.profile and not cfg.use_preview:
        renderer.profile_phases()
    t0 = time.perf_counter()
    renderer.export_image(cfg.render_path)
    renderer.phase_seconds["export"] = time.perf_counter() - t0
    return renderer


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(sys.argv if argv is None else argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
