"""Intersector selection.

The integrator (``render/integrator.py``) is agnostic to how rays are
intersected; this module picks the backend:

- ``"dense"`` — the dense kernels K1/K2 (``ops/intersect_cuda.py``): CUDA
  on a GPU, their plain torch versions on the CPU;
- ``"brute"`` — masked all-pairs Moller-Trumbore (``geometry/intersect.py``),
  the oracle;
- ``"auto"``  — picks by scene size.  Scenes above the dense limit need the
  cluster kernels (GPU) or the BVH (CPU), which are not ported yet, so
  ``auto`` raises for them instead of degrading to a slower path.
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
from chiaroscuro_tpu_torch.scene.scene_arrays import SceneTensors

# Largest scene the dense sweep serves (the JAX package's
# AUTO_BVH_THRESHOLD: above it the TPU takes the cluster path).
AUTO_DENSE_MAX_TRIS = 4096


def resolve_auto(n_tris: int, on_gpu: bool) -> str:
    """The ``"auto"`` backend decision."""
    if n_tris <= AUTO_DENSE_MAX_TRIS:
        return "dense"
    if on_gpu:
        raise NotImplementedError(
            f"scene has {n_tris} triangles > {AUTO_DENSE_MAX_TRIS}: the "
            "cluster intersection kernels are not ported yet (ROADMAP item 9)"
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

    if method in ("bvh", "cluster", "pallas"):
        raise NotImplementedError(
            f"intersector {method!r} is not ported; use 'dense' (the CUDA "
            "kernels), 'brute' or 'auto'"
        )
    raise ValueError(f"unknown intersector method: {method!r}")
