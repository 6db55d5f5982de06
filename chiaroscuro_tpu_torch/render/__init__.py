"""Wavefront integrator, renderer, tone mapping and image I/O."""
