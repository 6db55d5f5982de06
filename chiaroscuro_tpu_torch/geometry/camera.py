"""Camera ray generation from (eye, look-at, up, yview).

Reproduces the reference's screen-corner rotation math
(``src/rayTracer.cpp:41-49``): with z = 1, y = z * yview / 2,
x = y * xres / yres, the pixel-step vectors and upper-left corner are rotated
by the inverse of the ``glm::lookAt`` rotation, whose columns are the
camera's right / up / -forward axes.

Primary ray directions are intentionally **unnormalized**, as in the reference
(``rayTracer.cpp:60-62``): Moller-Trumbore's barycentric output and hit points
are invariant to |dir|, and all shading uses re-normalized vectors.
"""

from __future__ import annotations

import numpy as np


def camera_basis(eye, center, up, yview, xres: int, yres: int):
    """Returns (left_upper, dx, dy) as float32 numpy (3,) vectors: the
    world-space upper-left ray direction and the per-pixel step vectors
    (``rayTracer.cpp:41-49``).  This is the JAX package's numpy branch,
    unchanged, so the basis is bit-equal to it; callers move the three
    vectors to the device."""

    def _normalize(v):
        return v / np.linalg.norm(v)

    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)

    z = np.float32(1.0)
    y = z * 0.5 * np.float32(yview)
    x = y * (np.float32(xres) / np.float32(yres))

    # glm::lookAt basis: f = normalize(center-eye), s = normalize(cross(f, up)),
    # u = cross(s, f).  inverse(mat3(lookAt)) has columns [s, u, -f], so
    # rotate * (vx, vy, vz) = vx*s + vy*u - vz*f.
    f = _normalize(center - eye)
    s = _normalize(np.cross(f, up))
    u = np.cross(s, f)

    dy = (1.0 / yres) * (-2.0 * y) * u          # rotate * (0, -2y, 0) / yres
    dx = (1.0 / xres) * (2.0 * x) * s           # rotate * (2x, 0, 0) / xres
    left_upper = -x * s + y * u + z * f         # rotate * (-x, y, -z)
    return left_upper, dx, dy


def primary_ray_dirs(left_upper, dx, dy, px, py, jx, jy):
    """Row-major :func:`primary_ray_dirs_planar`: broadcastable px/py/jx/jy
    -> (..., 3) unnormalized directions (``rayTracer.cpp:60-62``)."""
    cx = (px + jx)[..., None]
    cy = (py + jy)[..., None]
    return left_upper + cx * dx + cy * dy


def primary_ray_dirs_planar(left_upper, dx, dy, px, py, jx, jy):
    """Unnormalized primary directions (``rayTracer.cpp:60-62``): (3,)
    tensors ``left_upper, dx, dy`` and pixel columns/rows ``px, py`` with AA
    jitters ``jx, jy`` shaped B -> (3, *B) component-major directions."""
    cx = (px + jx)[None]
    cy = (py + jy)[None]
    exp = (slice(None),) + (None,) * (cx.dim() - 1)
    return left_upper[exp] + cx * dx[exp] + cy * dy[exp]
