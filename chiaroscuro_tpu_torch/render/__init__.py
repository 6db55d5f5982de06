"""Wavefront integrator, renderer, tone mapping and image I/O."""

from chiaroscuro_tpu_torch.render.image_io import read_exr, write_exr, write_image
from chiaroscuro_tpu_torch.render.integrator import texture_kd_lookup, trace_paths
from chiaroscuro_tpu_torch.render.renderer import Renderer, render_image, render_samples
from chiaroscuro_tpu_torch.render.tonemap import normalize_image

__all__ = [
    "trace_paths",
    "texture_kd_lookup",
    "Renderer",
    "render_image",
    "render_samples",
    "normalize_image",
    "read_exr",
    "write_exr",
    "write_image",
]
