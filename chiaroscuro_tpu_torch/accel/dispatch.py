"""Intersector selection.

The integrator (``render/integrator.py``) is agnostic to how rays are
intersected; this module picks the backend:

- ``"dense"``   — the dense kernels K1/K2 (``ops/intersect_cuda.py``):
  CUDA on a GPU, their plain torch versions on the CPU; ``"pallas"``, the
  JAX package's name for the dense Pallas sweep that K1/K2 port, selects
  the same pair, so a ``.rtc`` written for that package renders;
- ``"cluster"`` — the cluster cull K3, then the resident visits K4/K5 or
  the streaming visits K6/K7 (``ops/cluster_cuda.py``): CUDA on
  a GPU, their plain torch versions on the CPU.  The route follows the JAX
  package's rule: resident while the packed cluster matrix is within 72 MiB
  (every scene from 4,097 triangles to about 384k at M = 128), streaming
  above; the pair exposes it as ``.route``;
- ``"bvh"``     — the flattened threaded BVH (``accel/bvh.py``), the
  structural analog of the reference's kd-tree: the walks B1/B2
  (``ops/bvh_cuda.py``, one thread a ray) on a GPU, the JAX package's
  lock-step loop on the CPU.  It has no gradient with respect to the
  vertices and raises where they require grad; material gradients flow;
- ``"brute"``   — masked all-pairs Moller-Trumbore (``geometry/intersect.py``),
  the oracle;
- ``"auto"``    — picks by scene size and device, as the JAX package does
  above 4,096 triangles: dense up to 4,096 triangles; above, cluster on a
  GPU below 2^24 triangles (the cluster ids' cap), else the BVH, with a
  ``RuntimeWarning`` on a GPU.

Every pair speaks the row-major oracle interface of ``geometry/intersect.py``
and carries ``.planar_fn``: the planar ``(3, B0, 128)`` functions
``closest(o3, d3, live=None)``, whose ``ClosestHit`` carries the hit's
shading-attribute row (``ClosestHit.attrs``) from the scene the pair is made
from, and ``any(o3, d3, tmax, excl, live=None)``, which the integrator, the
raster frame and the phase profiler call.  The brute and BVH pairs get theirs
from ``ops/intersect_cuda.planar_pair``; ``live`` is a (B0, 1) row hint that
only the dense pair reads.

Every pair is differentiable through its closest-hit query when it is made
from a scene whose fields require grad (the BVH's through the materials
only); a loss rebuilds the pair on each parameter-substituted scene, and the
cluster path takes a prebuilt ``clusters`` decomposition so that it does not
re-cluster (``bench.py:340-357``).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

from chiaroscuro_tpu_torch.accel.clusters import ClusterArrays
from chiaroscuro_tpu_torch.geometry.intersect import (
    AnyFn,
    ClosestFn,
    ClosestHit,
    intersect_any_bruteforce,
    intersect_closest_bruteforce,
)
from chiaroscuro_tpu_torch.ops import cluster_cuda
from chiaroscuro_tpu_torch.ops.intersect_cuda import (
    _prep_attrs,
    make_dense_intersectors,
    planar_pair,
)
from chiaroscuro_tpu_torch.scene.scene_arrays import SceneTensors

# Largest scene the dense sweep serves (the JAX package's
# AUTO_BVH_THRESHOLD: above it the TPU takes the cluster path).
AUTO_DENSE_MAX_TRIS = 4096


def resolve_auto(n_tris: int, on_gpu: bool) -> str:
    """The ``"auto"`` backend decision."""
    if n_tris <= AUTO_DENSE_MAX_TRIS:
        return "dense"
    if on_gpu and n_tris < cluster_cuda.MAX_TRIS:
        return "cluster"
    if on_gpu:
        warnings.warn(
            f"scene has {n_tris} triangles >= 2^24: the cluster intersector's "
            "triangle ids cannot represent it, degrading to the BVH walk "
            "(B1/B2, one thread a ray). Split the scene or reduce triangle "
            "count.",
            RuntimeWarning, stacklevel=3,
        )
    return "bvh"


def make_intersectors(
    scene: SceneTensors,
    method: str = "auto",
    chunk: int = 2048,
    clusters: Optional[ClusterArrays] = None,
) -> Tuple[ClosestFn, AnyFn]:
    """The (closest_fn, any_fn) pair of ``method`` for ``scene``;
    ``clusters`` (a prebuilt ``ClusterArrays``) is passed to the cluster
    path and ignored by the others."""
    if method == "auto":
        method = resolve_auto(scene.n_tris, scene.device.type == "cuda")

    if method in ("dense", "pallas"):
        return make_dense_intersectors(scene)

    if method == "brute":
        tv0, tv1, tv2 = scene.tri_v0, scene.tri_v1, scene.tri_v2

        def closest_fn(origins, dirs) -> ClosestHit:
            hit, t, tid, u, v = intersect_closest_bruteforce(
                origins, dirs, tv0, tv1, tv2, chunk
            )
            return ClosestHit(hit, t, tid, u, v)

        def any_fn(origins, dirs, tmax, exclude_id):
            return intersect_any_bruteforce(
                origins, dirs, tv0, tv1, tv2, tmax, exclude_id, chunk
            )

        closest_fn.planar_fn, any_fn.planar_fn = planar_pair(
            closest_fn, any_fn, _prep_attrs(scene)
        )
        return closest_fn, any_fn

    if method == "cluster":
        return cluster_cuda.make_cluster_intersectors(scene, clusters=clusters)

    if method == "bvh":
        from chiaroscuro_tpu_torch.accel.bvh import build_bvh, make_bvh_intersectors

        return make_bvh_intersectors(scene, build_bvh(scene))
    raise ValueError(f"unknown intersector method: {method!r}")
