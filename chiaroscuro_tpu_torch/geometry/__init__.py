"""Planar vec3 math, camera rays and the brute-force intersection oracle."""
