"""Importance samplers: concentric disk map + cosine-weighted hemisphere.

Branchless (``torch.where``) port of ``chiaroscuro_tpu/sampling/samplers.py``,
itself the reference's samplers (``src/brdf.cpp:10-62``).  The eight-region
concentric square->disk map and the tangent-frame construction reproduce the
reference's math so that renders agree in distribution.  The Phong lobe
samplers are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from chiaroscuro_tpu_torch.geometry import planar as P

M_PI = float(np.float32(np.pi))
M_1_PI = float(np.float32(1.0 / np.pi))


def _safe(x):
    return torch.where(x == 0.0, 1.0, x)


def concentric_sample_disk(u, v):
    """Map uniforms (u, v) in [0,1)^2 to a uniform point on the unit disk.

    Reference ``concentricSampleDisk`` (``src/brdf.cpp:18-54``): the inputs
    there are uniforms on [-1,1]^2; we map u,v -> sx,sy = 2u-1, 2v-1.
    Returns (dx, dy).
    """
    sx = 2.0 * u - 1.0
    sy = 2.0 * v - 1.0

    abs_zero = (sx == 0.0) & (sy == 0.0)

    # Region select (brdf.cpp:31-50).
    r1 = sx
    t1 = torch.where(sy > 0.0, sy / _safe(r1), 8.0 + sy / _safe(r1))
    r2 = sy
    t2 = 2.0 - sx / _safe(r2)
    r3 = -sx
    t3 = 4.0 - sy / _safe(r3)
    r4 = -sy
    t4 = 6.0 + sx / _safe(r4)

    in_12 = sx >= -sy
    in_1 = sx > sy
    in_3 = sx <= sy

    r = torch.where(in_12, torch.where(in_1, r1, r2), torch.where(in_3, r3, r4))
    theta = torch.where(
        in_12, torch.where(in_1, t1, t2), torch.where(in_3, t3, t4)
    )
    theta = theta * (M_PI / 4.0)

    dx = torch.where(abs_zero, 0.0, r * torch.cos(theta))
    dy = torch.where(abs_zero, 0.0, r * torch.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u, v):
    """Cosine-distributed direction in local (tangent, bitangent, normal)
    coordinates (``src/brdf.cpp:57-62``). Returns (x, y, z) with z >= 0."""
    dx, dy = concentric_sample_disk(u, v)
    dz = torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    return dx, dy, dz


def perpendicular_planar(n):
    """A vector perpendicular to planar n (``src/brdf.cpp:10-15``)."""
    x, y, z = n[0], n[1], n[2]
    cond = x.abs() < y.abs()
    return P.pvec(
        torch.where(cond, 0.0, -z),
        torch.where(cond, -z, 0.0),
        torch.where(cond, y, x),
    )


def tangent_frame_planar(n):
    """(tangent, bitangent) as the reference builds them
    (``src/brdf.cpp:73-74``); n need not be unit."""
    tangent = P.pnormalize(perpendicular_planar(n))
    bitangent = P.pnormalize(P.pcross(tangent, n))
    return tangent, bitangent


def sample_wi_diffuse_planar(n, u, v):
    """Cosine-weighted hemisphere sample about (possibly non-unit) planar
    normal n: returns (wi (3, *B) unit, pdf B) with pdf = max(0, n.wi)/pi
    against the *raw* normal, as ``Diffuse::sample_wi``
    (``src/brdf.cpp:72-79``)."""
    tangent, bitangent = tangent_frame_planar(n)
    sx, sy, sz = cosine_sample_hemisphere(u, v)
    wi = P.pnormalize(
        P.pscale(sx, tangent) + P.pscale(sy, bitangent) + P.pscale(sz, n)
    )
    pdf = torch.clamp_min(P.pdot(n, wi), 0.0) * M_1_PI
    return wi, pdf
