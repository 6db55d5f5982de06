"""The port's PRNG streams and samplers against the JAX package.

Threefry bits are integers: they must be equal, and so must the uniforms
built from them (a bitcast and one exact subtraction).  The samplers go
through sin/cos/sqrt/rsqrt, which XLA and torch evaluate with different
polynomials and fusions: atol 1e-6 on unit-scale outputs (a few f32 ulps);
the diffuse direction, a normalized sum of three terms, atol 2e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.sampling import prng as jprng
from chiaroscuro_tpu.sampling import samplers as jsamplers
from chiaroscuro_tpu_torch.sampling import prng
from chiaroscuro_tpu_torch.sampling import samplers

SEEDS = [0, 1, 0x9E3779B9, 2**32 - 1]


def _grid(seed):
    """(pixel, sample) pairs over a 768x768 frame and 0..1000 samples,
    including the corners of both ranges."""
    rng = np.random.default_rng(seed % 1000)
    pix = np.concatenate([[0, 768 * 768 - 1], rng.integers(0, 768 * 768, 4094)])
    smp = np.concatenate([[0, 1000], rng.integers(0, 1001, 4094)])
    return pix.astype(np.int32).reshape(32, 128), smp.astype(np.int32).reshape(32, 128)


def _u32(x):
    return np.asarray(x).astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_streams_equal_jax_bitwise(seed):
    pix, smp = _grid(seed)
    k0, k1 = prng.base_key(seed, torch.from_numpy(pix), torch.from_numpy(smp))
    j0, j1 = jprng.base_key(jnp.uint32(seed), jnp.asarray(pix), jnp.asarray(smp))
    np.testing.assert_array_equal(k0.numpy().astype(np.uint32), _u32(j0))
    np.testing.assert_array_equal(k1.numpy().astype(np.uint32), _u32(j1))

    jx, jy = prng.aa_jitter_pair(k0, k1)
    rx, ry = jprng.aa_jitter_pair(j0, j1)
    np.testing.assert_array_equal(jx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(jy.numpy(), np.asarray(ry))
    assert jx.dtype == torch.float32 and 0.0 <= float(jx.min()) and float(jx.max()) < 1.0

    for bounce in range(1, 7):
        un = prng.bounce_uniforms_planar(k0, k1, bounce)
        ref = jprng.bounce_uniforms_planar(j0, j1, bounce)
        assert un.shape == (prng.N_BOUNCE_DIMS, 32, 128)
        np.testing.assert_array_equal(un.numpy(), np.asarray(ref))


def test_threefry_block_equals_jax_on_extreme_words():
    w = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32)
    a, b, c, d = np.meshgrid(w, w, w, w, indexing="ij")
    got = prng.threefry2x32(*(torch.from_numpy(x.astype(np.int64)) for x in (a, b, c, d)))
    ref = jprng.threefry2x32(*(jnp.asarray(x) for x in (a, b, c, d)))
    for g, r in zip(got, ref):
        assert int(g.min()) >= 0 and int(g.max()) < 2**32
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), _u32(r))


def _uniforms(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=n).astype(np.float32)
    v = rng.uniform(size=n).astype(np.float32)
    u[:4] = [0.5, 0.5, 0.0, 0.25]     # the disk centre and region edges
    v[:4] = [0.5, 0.0, 0.5, 0.25]
    return u, v


def test_concentric_disk_and_hemisphere_match_jax():
    u, v = _uniforms(4096, 1)
    got = samplers.cosine_sample_hemisphere(torch.from_numpy(u), torch.from_numpy(v))
    ref = jsamplers.cosine_sample_hemisphere(jnp.asarray(u), jnp.asarray(v))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    dx, dy = samplers.concentric_sample_disk(torch.from_numpy(u), torch.from_numpy(v))
    assert float((dx * dx + dy * dy).max()) <= 1.0 + 1e-6
    assert float(dx[0]) == 0.0 and float(dy[0]) == 0.0


def test_diffuse_sampling_frames_match_jax():
    rng = np.random.default_rng(2)
    # Unit normals, as the scene's flat normals are, plus axis normals and
    # a row of shorter ones (a mean of vertex normals need not be unit).
    n = rng.normal(size=(3, 8, 128))
    n = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
    n[:, 0, :3] = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]
    n[:, 1] *= 0.37
    u, v = (x.reshape(8, 128) for x in _uniforms(1024, 3))
    tn = torch.from_numpy(n)
    jn = jnp.asarray(n)

    np.testing.assert_array_equal(
        samplers.perpendicular_planar(tn).numpy(),
        np.asarray(jsamplers.perpendicular_planar(jn)),
    )
    for g, r in zip(samplers.tangent_frame_planar(tn), jsamplers.tangent_frame_planar(jn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    wi, pdf = samplers.sample_wi_diffuse_planar(tn, torch.from_numpy(u), torch.from_numpy(v))
    rwi, rpdf = jsamplers.sample_wi_diffuse_planar(jn, jnp.asarray(u), jnp.asarray(v))
    # wi normalizes sx*t + sy*b + sz*n; where the terms nearly cancel the
    # normalization magnifies their rounding (XLA contracts them into FMAs,
    # torch rounds each op).  Found: one of 3072 components at 1.55e-6.
    np.testing.assert_allclose(wi.numpy(), np.asarray(rwi), rtol=0, atol=2e-6)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(rpdf), rtol=0, atol=2e-6)
    norm = (wi * wi).sum(0).sqrt()
    torch.testing.assert_close(norm, torch.ones_like(norm), rtol=0, atol=1e-6)
