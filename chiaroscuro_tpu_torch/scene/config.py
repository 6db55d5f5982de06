"""Render configuration: ``.rtc`` keyword-stream files + CLI overrides.

Reproduces the semantics of the reference scene/config system
(``src/scene.cpp:13-72``): a ``.rtc`` file is split into one token per
non-empty line; CLI arguments are appended after the file tokens; the combined
stream is scanned left-to-right with last-wins assignment.  Lines starting with
``#`` are comments.  Unrecognized tokens emit a warning and are skipped.

Recognized keys (reference ``src/scene.cpp:17-59``)::

    input <path>           OBJ scene path
    output <path>          image output path (.exr/.hdr -> HDR, else tone-mapped)
    k <int>                max path depth (bounces)
    xres <int> / yres <int>
    VP <x> <y> <z>         camera position ("view point")
    LA <x> <y> <z>         camera look-at target
    UP <x> <y> <z>         camera up vector
    yview <float>          vertical view extent at z=1 (2*tan(fov_y/2))
    samples <int>          Monte-Carlo samples per pixel
    exposure <float>       tone-map exposure for PNG export / preview
    kdtree-leaf-size <int> acceleration-structure leaf size
    preview-height <int>   preview window height
    no-preview             disable the interactive preview

Defaults mirror the reference (``src/scene.cpp:63-65``).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Sequence, Tuple

Vec3 = Tuple[float, float, float]


KEYWORDS = {
    "no-preview", "input", "output", "k", "xres", "yres", "VP", "LA", "UP",
    "yview", "preview-height", "samples", "exposure", "kdtree-leaf-size",
    "seed", "intersector", "spp-chunk", "platform", "specular", "profile",
    "point-lights",
}


@dataclasses.dataclass
class LightPoint:
    """Legacy point light (reference ``scene.hpp:11-16`` — dead code there:
    the reference parser has no ``L`` branch, SURVEY.md §3.3).  We support it
    as an extension so the reference's legacy ``.rtc`` files load."""

    position: Vec3
    color: Vec3
    intensity: float


@dataclasses.dataclass
class RenderConfig:
    obj_path: str = ""
    render_path: str = "renders/output.exr"
    k: int = 3
    xres: int = 400
    yres: int = 300
    vp: Vec3 = (0.0, 0.0, 2.0)
    la: Vec3 = (0.0, 0.0, 0.0)
    up: Vec3 = (0.0, 1.0, 0.0)
    yview: float = 1.0
    use_preview: bool = True
    preview_height: int = 900
    kdtree_leaf_size: int = 8
    background: Vec3 = (0.0, 0.0, 0.0)
    samples: int = 100
    exposure: float = 5.0

    # --- framework extensions (not in the reference) -----------------------
    seed: int = 0                    # base PRNG seed (counter-based streams)
    intersector: str = "auto"        # "auto" | "dense" (or "pallas") | "cluster"
                                     # | "bvh" | "brute"
    spp_chunk: int = 0               # render samples in chunks of this size (0 = all at once)
    platform: str = "cuda"           # torch device: "cuda" (default) or "cpu"
    enable_specular: bool = False    # Phong specular extension (off = reference parity)
    profile: bool = False            # print the per-phase breakdown after the render
    use_point_lights: bool = True    # shade legacy `L` point lights in the integrator
                                     # (the reference loads none and shades none; its
                                     # shipped legacy renders ARE lit by them — see
                                     # scene_arrays.SceneTensors.pl_pos)
    light_points: list = dataclasses.field(default_factory=list)  # [LightPoint]

    @classmethod
    def from_tokens(cls, tokens: Sequence[str]) -> "RenderConfig":
        """Parse a token stream with last-wins assignment (``scene.cpp:17-59``)."""
        return cls._apply_tokens(cls(), tokens)

    @classmethod
    def _apply_tokens(cls, cfg: "RenderConfig", tokens: Sequence[str]) -> "RenderConfig":
        i = 0
        n = len(tokens)

        def take() -> str:
            nonlocal i
            i += 1
            if i >= n:
                raise ValueError("unexpected end of config token stream")
            return tokens[i]

        def take_vec3() -> Vec3:
            return (float(take()), float(take()), float(take()))

        while i < n:
            tok = tokens[i]
            if tok.startswith("#"):
                pass
            elif tok == "no-preview":
                cfg.use_preview = False
            elif tok == "input":
                cfg.obj_path = take()
            elif tok == "output":
                cfg.render_path = take()
            elif tok == "k":
                cfg.k = int(take())
            elif tok == "xres":
                cfg.xres = int(take())
            elif tok == "yres":
                cfg.yres = int(take())
            elif tok == "VP":
                cfg.vp = take_vec3()
            elif tok == "LA":
                cfg.la = take_vec3()
            elif tok == "UP":
                cfg.up = take_vec3()
            elif tok == "yview":
                cfg.yview = float(take())
            elif tok == "preview-height":
                cfg.preview_height = int(take())
            elif tok == "samples":
                cfg.samples = int(take())
            elif tok == "exposure":
                cfg.exposure = float(take())
            elif tok == "kdtree-leaf-size":
                cfg.kdtree_leaf_size = int(take())
            # --- extensions ---
            elif tok == "seed":
                cfg.seed = int(take())
            elif tok == "intersector":
                cfg.intersector = take()
            elif tok == "spp-chunk":
                cfg.spp_chunk = int(take())
            elif tok == "platform":
                cfg.platform = take()
            elif tok == "specular":
                cfg.enable_specular = take().lower() in ("on", "true", "1")
            elif tok == "profile":
                cfg.profile = take().lower() in ("on", "true", "1")
            elif tok == "point-lights":
                cfg.use_point_lights = take().lower() in ("on", "true", "1")
            else:
                print(f'Invalid argument "{tok}"', file=sys.stderr)
            i += 1
        return cfg

    @classmethod
    def from_rtc(cls, path: str, extra_args: Sequence[str] = ()) -> "RenderConfig":
        """Load an ``.rtc`` file; ``extra_args`` are appended (CLI override).

        The file is split one token per non-empty *line* (``scene.cpp:66-71``);
        a line starting with ``#`` is one comment token.

        Extension: the reference's *legacy positional* format (shipped in
        ``nanosuit.rtc`` / ``view_test.rtc`` but unparseable by the reference
        itself — SURVEY.md quirk 3) is auto-detected and parsed, including
        ``L x y z r g b intensity`` point-light lines.
        """
        lines = []
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if len(line) > 0:
                    lines.append(line)

        content = [l for l in lines if not l.lstrip().startswith("#")]
        if content and content[0].strip() not in KEYWORDS:
            cfg = cls._from_legacy_lines(content)
            # CLI overrides still apply on top.
            return cls._apply_tokens(cfg, list(extra_args))

        tokens = lines + list(extra_args)
        return cls.from_tokens(tokens)

    @classmethod
    def _from_legacy_lines(cls, content) -> "RenderConfig":
        """Positional format: obj, output, k, 'xres yres', VP, LA, UP,
        yview, then zero or more 'L x y z r g b intensity' lines."""
        cfg = cls()
        fields = [l.split() for l in content]
        try:
            cfg.obj_path = content[0].strip()
            cfg.render_path = content[1].strip()
            cfg.k = int(fields[2][0])
            cfg.xres, cfg.yres = int(fields[3][0]), int(fields[3][1])
            cfg.vp = tuple(float(x) for x in fields[4][:3])
            cfg.la = tuple(float(x) for x in fields[5][:3])
            cfg.up = tuple(float(x) for x in fields[6][:3])
            cfg.yview = float(fields[7][0])
        except (IndexError, ValueError) as e:
            raise ValueError(f"malformed legacy .rtc: {e}") from e
        for f in fields[8:]:
            if f and f[0] == "L":
                vals = [float(x) for x in f[1:8]]
                cfg.light_points.append(
                    LightPoint(
                        position=tuple(vals[0:3]),
                        color=tuple(vals[3:6]),
                        intensity=vals[6],
                    )
                )
        return cfg

    @classmethod
    def from_argv(cls, argv: Sequence[str]) -> "RenderConfig":
        """CLI entry parity with the reference: ``main [scene.rtc] [key value ...]``."""
        rtc = argv[1] if len(argv) > 1 else "cornell.rtc"
        return cls.from_rtc(rtc, argv[2:])
