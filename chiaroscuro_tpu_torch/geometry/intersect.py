"""Batched ray-triangle intersection (Moller-Trumbore): the port's oracle.

The brute-force closest-hit/any-hit intersectors test every (ray, triangle)
pair with a masked reduction, streaming triangles in chunks so that peak
memory is O(rays * chunk).  The math is the reference's Moller-Trumbore
variant (``src/kdtree.cpp:219-246``), including its epsilon and acceptance
conditions:

    |a| < float32_eps           -> miss   (parallel ray)
    u in [0, 1], v >= 0, u+v <= 1
    t >= 0                      -> hit at distance t (in units of |dir|)

They are the reference every kernel in ``ops/`` is tested against, and the
explicit ``intersector brute`` choice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

FLT_EPS = float(np.finfo(np.float32).eps)
INF = float("inf")


class ClosestHit(NamedTuple):
    """Result of a closest-hit query over a ray wavefront.

    ``attrs`` carries the winner's shading-attribute row in every pair's
    planar answer (``.planar_fn``; the kernels load it, the brute and BVH
    pairs gather it), as a dict of planar tensors keyed as
    ``ops.intersect_cuda.ATTR_LAYOUT``; the brute and BVH row functions
    leave it ``None``.
    """

    hit: torch.Tensor   # bool
    t: torch.Tensor     # f32 distance in units of |dir|
    tid: torch.Tensor   # int32 triangle id
    u: torch.Tensor     # f32 barycentric weight of v1
    v: torch.Tensor     # f32 barycentric weight of v2
    attrs: object = None  # Optional[dict[str, torch.Tensor]]


# closest_fn(origins, dirs) -> ClosestHit
ClosestFn = Callable[[torch.Tensor, torch.Tensor], ClosestHit]
# any_fn(origins, dirs, tmax, exclude_id) -> occluded (R,) bool
AnyFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor
]


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def moller_trumbore(origins, dirs, v0, v1, v2):
    """All-pairs Moller-Trumbore.

    origins, dirs: (R, 3); v0, v1, v2: (T, 3).
    Returns (valid, t, u, v), each (R, T).
    """
    e1 = v1 - v0
    e2 = v2 - v0

    d = dirs[:, None, :]
    p = torch.linalg.cross(d, e2[None])              # (R, T, 3)
    a = _dot(e1[None], p)

    nonparallel = a.abs() >= FLT_EPS
    f = 1.0 / torch.where(nonparallel, a, 1.0)

    s = origins[:, None, :] - v0[None, :, :]
    u = f * _dot(s, p)
    q = torch.linalg.cross(s, e1[None])             # (R, T, 3)
    v = f * _dot(d, q)
    t = f * _dot(e2[None], q)

    valid = (
        nonparallel
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= 0.0)
    )
    return valid, t, u, v


def intersect_closest_bruteforce(origins, dirs, v0, v1, v2, chunk: int = 2048):
    """Closest-hit over all triangles.

    Returns (hit, t, tri_id, u, v) with shapes (R,).  Ties in t resolve to the
    lowest triangle id, matching the reference's in-order leaf sweep with a
    strict ``dist < tmax`` update (``kdtree.cpp:253-261``).
    """
    R = origins.shape[0]
    dev = origins.device
    best_t = torch.full((R,), INF, device=dev)
    best_id = torch.zeros((R,), dtype=torch.int32, device=dev)
    best_u = torch.zeros((R,), device=dev)
    best_v = torch.zeros((R,), device=dev)
    rows = torch.arange(R, device=dev)
    for base in range(0, v0.shape[0], chunk):
        sl = slice(base, base + chunk)
        valid, t, u, v = moller_trumbore(origins, dirs, v0[sl], v1[sl], v2[sl])
        t = torch.where(valid, t, INF)
        local = torch.argmin(t, dim=1)
        ct, cu, cv = t[rows, local], u[rows, local], v[rows, local]
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_id = torch.where(better, (base + local).to(torch.int32), best_id)
        best_u = torch.where(better, cu, best_u)
        best_v = torch.where(better, cv, best_v)
    return torch.isfinite(best_t), best_t, best_id, best_u, best_v


def intersect_any_bruteforce(
    origins, dirs, v0, v1, v2, tmax, exclude_id, chunk: int = 2048
):
    """Any-hit (shadow) query: does any triangle with id != exclude_id block
    the ray at t in [0, tmax)?  (``kdtree.cpp:283-344``.)

    origins, dirs: (R, 3); tmax, exclude_id: (R,).  Returns occluded (R,).
    """
    occluded = torch.zeros(origins.shape[0], dtype=torch.bool, device=origins.device)
    for base in range(0, v0.shape[0], chunk):
        sl = slice(base, base + chunk)
        valid, t, _, _ = moller_trumbore(origins, dirs, v0[sl], v1[sl], v2[sl])
        ids = torch.arange(base, base + t.shape[1], device=origins.device)
        blocking = (
            valid & (t < tmax[:, None]) & (ids[None, :] != exclude_id[:, None])
        )
        occluded = occluded | blocking.any(dim=1)
    return occluded


def intersect_aabb(origins, dirs, box_min, box_max):
    """Slab test (``kdtree.cpp:196-208``): (tmin, tmax) per ray of (R, 3)
    origins and directions against one box; the ray meets the box where
    ``tmax >= 0 and tmax >= tmin`` (``kdtree.cpp:213``).  A zero direction
    component divides to an IEEE infinity, as the reference's does."""
    inv = 1.0 / dirs
    t0 = (box_min[None, :] - origins) * inv              # (R, 3)
    t1 = (box_max[None, :] - origins) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return tmin, tmax
