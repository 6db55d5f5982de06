"""Planar vec3 math, camera rays and the brute-force intersection oracle."""

from chiaroscuro_tpu_torch.geometry.camera import camera_basis, primary_ray_dirs
from chiaroscuro_tpu_torch.geometry.intersect import (
    AnyFn,
    ClosestFn,
    ClosestHit,
    intersect_aabb,
    intersect_any_bruteforce,
    intersect_closest_bruteforce,
    moller_trumbore,
)

__all__ = [
    "camera_basis",
    "primary_ray_dirs",
    "AnyFn",
    "ClosestFn",
    "ClosestHit",
    "intersect_aabb",
    "intersect_any_bruteforce",
    "intersect_closest_bruteforce",
    "moller_trumbore",
]
