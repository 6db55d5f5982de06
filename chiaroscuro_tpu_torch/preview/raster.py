"""Walk-through "raster" frame — analog of the reference's TAB raster mode.

The port of ``chiaroscuro_tpu/preview/raster.py``.  The reference's preview
rasterizes the scene with OpenGL while flying the camera
(``src/openglPreview.cpp:67-89``): textured meshes draw their diffuse
texture directly (``shader/simple_fs.glsl``), untextured meshes draw Phong
ambient/diffuse/specular from **one** light — the first point light, or a
white light at the scene's VP when there are none (``openglPreview.cpp:82-86``,
``shader/material.fs:24-43``).

The frame is made by the path tracer's own machinery on the scene's device:
one primary-visibility closest-hit wavefront (no bounces, no NEE, no RNG)
through the renderer's intersector's ``.planar_fn``, which answers in the
planar layout with the winner's attribute row, shaded per the shaders above.

Divergence (documented): ``material.fs`` reads the material's *ambient* color;
``SceneTensors`` deliberately has no Ka field (the loader's Ka→Ke promotion
rule, ``scene/obj_loader.py``), so ambient ≈ 0.1 * Kd here.
"""

from __future__ import annotations

import numpy as np
import torch

from chiaroscuro_tpu_torch.geometry import planar as P
from chiaroscuro_tpu_torch.geometry.camera import camera_basis, primary_ray_dirs_planar
from chiaroscuro_tpu_torch.render.integrator import _atlas_fetch_planar
from chiaroscuro_tpu_torch.scene.scene_arrays import SceneTensors

AMBIENT = 0.1


@torch.no_grad()
def _raster(scene: SceneTensors, eye, center, up, yview, xres: int, yres: int,
            light_pos, light_color, closest_fn):
    """The frame as a (yres, xres, 3) tensor on the scene's device
    (``_raster_frame_jit`` of the JAX package)."""
    dev = scene.device
    left_upper, dx, dy = (torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in
                          camera_basis(eye, center, up, yview, xres, yres))
    ys, xs = torch.meshgrid(
        torch.arange(yres, dtype=torch.float32, device=dev),
        torch.arange(xres, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    R = xres * yres
    pad = (-R) % 128
    zeros = torch.zeros(pad, dtype=torch.float32, device=dev)
    B = ((R + pad) // 128, 128)
    pxf = torch.cat([xs.reshape(-1), zeros]).reshape(B)
    pyf = torch.cat([ys.reshape(-1), zeros]).reshape(B)
    # Pixel centers (no AA jitter in raster mode).
    dirs = primary_ray_dirs_planar(left_upper, dx, dy, pxf, pyf, 0.5, 0.5).contiguous()
    eye_t = torch.as_tensor(np.asarray(eye, np.float32), device=dev)
    origins = eye_t[:, None, None].expand((3,) + B).contiguous()

    res = closest_fn.planar_fn(origins, dirs)
    hit, bu, bv = res.hit, res.u, res.v
    A = res.attrs
    point = A["v0"] + P.pscale(bu, A["e1"]) + P.pscale(bv, A["e2"])
    normal, kd, ks, ns = A["normal"], A["kd"], A["ks"], A["ns"]
    texid = A["texid"]
    uvp = (
        A["uv0"] * (1.0 - bu - bv)[None]
        + A["uv1"] * bu[None]
        + A["uv2"] * bv[None]
    )

    n = P.pnormalize(normal)
    lp = light_pos[:, None, None]
    lc = light_color[:, None, None]
    ldir = P.pnormalize(lp - point)
    diff = torch.clamp_min(P.pdot(n, ldir), 0.0)
    vdir = P.pnormalize(origins - point)
    refl = 2.0 * P.pscale(P.pdot(ldir, n), n) - ldir
    spec = torch.pow(torch.clamp_min(P.pdot(vdir, refl), 0.0), torch.clamp_min(ns, 1.0))
    phong = lc * (AMBIENT * kd + P.pscale(diff, kd) + P.pscale(spec, ks))

    # Textured meshes: raw texture color (simple_fs.glsl); untextured: Phong.
    tex = _atlas_fetch_planar(scene, texid, uvp, kd)
    color = torch.where((texid >= 0)[None], tex, phong)
    color = P.pwhere(hit, color, 0.0)           # glClearColor black
    return P.to_rows(color)[:R].reshape(yres, xres, 3)


def raster_frame(scene: SceneTensors, cfg, camera, closest_fn) -> np.ndarray:
    """One flat-shaded walk-through frame from a :class:`FlyCamera`.

    Returns (yres, xres, 3) float32 in [0, ~inf) — display via clip, not the
    path tracer's tone map (the GL raster pipeline never tone-mapped either).
    """
    eye, center, up, yview = camera.render_args()
    if cfg.light_points:
        lp = np.asarray(cfg.light_points[0].position, np.float32)
        lc = np.asarray(cfg.light_points[0].color, np.float32)
    else:
        lp = np.asarray(cfg.vp, np.float32)      # openglPreview.cpp:83-86
        lc = np.ones(3, np.float32)
    dev = scene.device
    img = _raster(
        scene, eye, center, up, yview, cfg.xres, cfg.yres,
        torch.from_numpy(lp).to(dev), torch.from_numpy(lc).to(dev), closest_fn,
    )
    return img.cpu().numpy()
