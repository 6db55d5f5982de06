"""Counter-based PRNG streams and importance samplers."""

from chiaroscuro_tpu_torch.sampling.prng import (
    DIM_BSDF_U,
    DIM_BSDF_V,
    DIM_LIGHT_SEL,
    DIM_LIGHT_U,
    DIM_LIGHT_V,
    DIM_LOBE,
    DIM_RR,
    N_BOUNCE_DIMS,
    aa_jitter,
    bounce_uniforms,
    pixel_sample_key,
)
from chiaroscuro_tpu_torch.sampling.samplers import (
    concentric_sample_disk,
    cosine_sample_hemisphere,
    perpendicular,
    phong_pdf,
    reflect,
    sample_phong_lobe,
    sample_wi_diffuse,
    tangent_frame,
)

__all__ = [
    "aa_jitter",
    "bounce_uniforms",
    "pixel_sample_key",
    "N_BOUNCE_DIMS",
    "DIM_LIGHT_SEL",
    "DIM_LIGHT_U",
    "DIM_LIGHT_V",
    "DIM_RR",
    "DIM_BSDF_U",
    "DIM_BSDF_V",
    "DIM_LOBE",
    "concentric_sample_disk",
    "cosine_sample_hemisphere",
    "perpendicular",
    "tangent_frame",
    "sample_wi_diffuse",
    "reflect",
    "sample_phong_lobe",
    "phong_pdf",
]
