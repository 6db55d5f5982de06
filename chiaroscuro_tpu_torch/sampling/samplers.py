"""Importance samplers: concentric disk map + cosine-weighted hemisphere.

Branchless (``torch.where``) port of ``chiaroscuro_tpu/sampling/samplers.py``,
itself the reference's samplers (``src/brdf.cpp:10-62``).  The eight-region
concentric square->disk map and the tangent-frame construction reproduce the
reference's math so that renders agree in distribution.  The Phong lobe
samplers of the specular extension (not in the reference integrator, whose
``brdf.hpp:8`` has only Diffuse/Emissive) follow in both layouts: the
planar ``(3, *B)`` forms the integrator runs, and the row-major ``(..., 3)``
forms the JAX package exports.
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


def reflect_planar(wo, n_unit):
    """Mirror direction of planar ``wo`` about the unit normal:
    2*dot(n,wo)*n - wo."""
    return P.pscale(2.0 * P.pdot(n_unit, wo), n_unit) - wo


def sample_phong_lobe_planar(wr, ns, u, v):
    """A direction from the Phong lobe pdf (ns+1)/(2pi) cos^ns(alpha) about
    the unit planar reflection direction ``wr``: returns (wi, cos_alpha).
    ``u`` is clamped at 1e-12 before the 1/(ns+1) power, which keeps the
    power's exponent gradient (log u) finite."""
    cos_a = torch.pow(torch.clamp_min(u, 1e-12), 1.0 / (ns + 1.0))
    sin_a = torch.sqrt(torch.clamp_min(1.0 - cos_a * cos_a, 0.0))
    phi = 2.0 * M_PI * v
    tangent, bitangent = tangent_frame_planar(wr)
    wi = P.pnormalize(
        P.pscale(sin_a * torch.cos(phi), tangent)
        + P.pscale(sin_a * torch.sin(phi), bitangent)
        + P.pscale(cos_a, wr)
    )
    return wi, cos_a


def phong_pdf_planar(wr, wi, ns):
    """pdf of :func:`sample_phong_lobe_planar` at planar ``wi``."""
    cos_a = torch.clamp_min(P.pdot(wr, wi), 0.0)
    return (ns + 1.0) * (0.5 * M_1_PI) * torch.pow(cos_a, ns)


# ---------------------------------------------------------------------------
# Row-major (..., 3) forms: the planar functions on the transposed vectors.
# ---------------------------------------------------------------------------


def _planar(x):
    return torch.movedim(x, -1, 0)


def _rows(x):
    return torch.movedim(x, 0, -1)


def perpendicular(n):
    """A vector perpendicular to n (``src/brdf.cpp:10-15``). n: (..., 3)."""
    return _rows(perpendicular_planar(_planar(n)))


def tangent_frame(n):
    """(tangent, bitangent), each (..., 3), as the reference builds them
    (``src/brdf.cpp:73-74``); n need not be unit."""
    t, b = tangent_frame_planar(_planar(n))
    return _rows(t), _rows(b)


def sample_wi_diffuse(n, u, v):
    """Row-major :func:`sample_wi_diffuse_planar`: n (..., 3) -> (wi
    (..., 3), pdf (...))."""
    wi, pdf = sample_wi_diffuse_planar(_planar(n), u, v)
    return _rows(wi), pdf


def reflect(wo, n_unit):
    """Row-major :func:`reflect_planar`."""
    return _rows(reflect_planar(_planar(wo), _planar(n_unit)))


def sample_phong_lobe(wr, ns, u, v):
    """Row-major :func:`sample_phong_lobe_planar`: (wi (..., 3),
    cos_alpha (...))."""
    wi, cos_a = sample_phong_lobe_planar(_planar(wr), ns, u, v)
    return _rows(wi), cos_a


def phong_pdf(wr, wi, ns):
    """Row-major :func:`phong_pdf_planar`."""
    return phong_pdf_planar(_planar(wr), _planar(wi), ns)
