"""CLI entry point: ``python -m chiaroscuro_tpu_torch [scene.rtc] [key value ...]``.

Mirrors ``chiaroscuro_tpu/cli.py`` (the reference's ``main.cpp:5-21`` flow):
parse the config, load the scene, construct the renderer, run a one-shot
batch render and export the image.  ``platform`` picks the torch device:
``cuda`` (the default) or ``cpu``.  Without a CUDA device and without
``platform cpu`` the CLI raises rather than quietly rendering on the CPU.
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

import torch

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


def run(argv: Sequence[str]) -> Renderer:
    """The batch render of ``main``; returns the renderer (pixels and
    ``last_stats``)."""
    cfg = RenderConfig.from_argv(list(argv))
    device = resolve_device(cfg.platform)
    if cfg.use_preview:
        raise NotImplementedError(
            "the interactive preview is not ported yet (ROADMAP item 13); "
            "pass no-preview"
        )
    if cfg.profile:
        raise NotImplementedError(
            "profile_phases is not ported yet (ROADMAP item 12)"
        )

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
    renderer.ray_trace(cfg.vp, cfg.la, cfg.up, cfg.yview)
    t0 = time.perf_counter()
    renderer.export_image(cfg.render_path)
    renderer.phase_seconds["export"] = time.perf_counter() - t0
    return renderer


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(sys.argv if argv is None else argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
