"""Intersector selection.

The integrator (``render/integrator.py``) is agnostic to how rays are
intersected; this module picks the backend:

- ``"dense"``   — the dense kernels K1/K2 (``ops/intersect_cuda.py``):
  CUDA on a GPU, their plain torch versions on the CPU;
- ``"cluster"`` — the cluster cull K3 and streaming visits K6/K7
  (``ops/cluster_cuda.py``): Triton and CUDA on a GPU, their plain torch
  versions on the CPU;
- ``"brute"``   — masked all-pairs Moller-Trumbore (``geometry/intersect.py``),
  the oracle;
- ``"auto"``    — picks by scene size and device: dense up to 4,096
  triangles, cluster above on a GPU.  The CPU's large-scene path (the BVH)
  is not ported yet, so ``auto`` raises there instead of degrading to a
  slower path.
"""

from __future__ import annotations

from typing import Tuple

from chiaroscuro_tpu_torch.geometry.intersect import (
    AnyFn,
    ClosestFn,
    ClosestHit,
    intersect_any_bruteforce,
    intersect_closest_bruteforce,
)
from chiaroscuro_tpu_torch.ops import cluster_cuda
from chiaroscuro_tpu_torch.scene.scene_arrays import SceneTensors

# Largest scene the dense sweep serves (the JAX package's
# AUTO_BVH_THRESHOLD: above it the TPU takes the cluster path).
AUTO_DENSE_MAX_TRIS = 4096


def resolve_auto(n_tris: int, on_gpu: bool) -> str:
    """The ``"auto"`` backend decision."""
    if n_tris <= AUTO_DENSE_MAX_TRIS:
        return "dense"
    if on_gpu:
        if n_tris < cluster_cuda.MAX_TRIS:
            return "cluster"
        raise NotImplementedError(
            f"scene has {n_tris} triangles >= 2^24: the cluster path keeps "
            "ids below 2^24, and the BVH that the JAX package falls back to "
            "is not ported yet (ROADMAP item 10)"
        )
    raise NotImplementedError(
        f"scene has {n_tris} triangles > {AUTO_DENSE_MAX_TRIS}: the BVH "
        "path for large scenes on the CPU is not ported yet (ROADMAP item 10)"
    )


def make_intersectors(
    scene: SceneTensors, method: str = "auto", chunk: int = 2048
) -> Tuple[ClosestFn, AnyFn]:
    if method == "auto":
        method = resolve_auto(scene.n_tris, scene.device.type == "cuda")

    if method == "dense":
        from chiaroscuro_tpu_torch.ops.intersect_cuda import (
            make_dense_intersectors,
        )

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

        return closest_fn, any_fn

    if method == "cluster":
        return cluster_cuda.make_cluster_intersectors(scene)

    if method in ("bvh", "pallas"):
        raise NotImplementedError(
            f"intersector {method!r} is not ported; use 'dense' or "
            "'cluster' (the CUDA kernels), 'brute' or 'auto'"
        )
    raise ValueError(f"unknown intersector method: {method!r}")
