"""Planar vec3 math on tensors: structure-of-vectors layout.

The JAX package keeps every per-ray quantity 2-D over the ray axis — scalars
as ``(B0, 128)``, vec3 as ``(3, B0, 128)`` — to fill the TPU's (8, 128)
vector tiles.  The port keeps that layout at every public function so the
two packages can be compared like with like; on the GPU the 128-lane rows
cost nothing and give the intersection kernels one block per row.

Convention: ``p`` is a planar vec3 iff ``p.shape == (3, *B)`` for any batch
shape ``B``; per-ray scalars have shape ``B``.  All helpers are
rank-agnostic over ``B``.
"""

from __future__ import annotations

import torch


def pvec(x, y, z):
    """Stack per-ray components into a planar (3, *B) vector."""
    return torch.stack([x, y, z])


def pdot(a, b):
    """(3, *B) x (3, *B) -> B, summed in component order."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def pcross(a, b):
    return torch.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ]
    )


def pnorm(v):
    return torch.sqrt(torch.clamp_min(pdot(v, v), 1e-20))


def pnormalize(v):
    return v * torch.rsqrt(torch.clamp_min(pdot(v, v), 1e-20))[None]


def pwhere(mask, a, b):
    """Select planar vectors by a per-ray mask of shape B."""
    return torch.where(mask[None], a, b)


def pscale(s, v):
    """B * (3, *B)."""
    return s[None] * v


def to_planar(rows, batch_shape=None):
    """(R, 3) -> (3, *B) (B defaults to (R,)), contiguous."""
    p = rows.T
    if batch_shape is not None:
        p = p.reshape((3,) + tuple(batch_shape))
    return p.contiguous()


def to_rows(planar):
    """(3, *B) -> (prod(B), 3)."""
    return planar.reshape(3, -1).T
