"""The port's PRNG streams and samplers against the JAX package, and the
sample streams' kernels against the plain int64 version on the card.

Threefry bits are integers: they must be equal, and so must the uniforms
built from them (a bitcast and one exact subtraction).  The samplers go
through sin/cos/sqrt/rsqrt, which XLA and torch evaluate with different
polynomials and fusions: atol 1e-6 on unit-scale outputs (a few f32 ulps);
the diffuse direction, a normalized sum of three terms, atol 2e-6.

The kernels (``ops/threefry_cuda.py``, marker ``cuda``, skipped without a
card) must equal ``prng``'s int64 operator chain on the same card bit for
bit, and a captured raygen launch must read its sample index from device
memory at every replay.  The card's machine has no jax, so this file
imports it only where it is installed, and the card tests need none:

    python -m pytest --noconftest -q -m cuda tests/test_torch_sampling.py
"""

import numpy as np
import pytest
import torch

from chiaroscuro_tpu_torch.ops import threefry_cuda
from chiaroscuro_tpu_torch.sampling import prng
from chiaroscuro_tpu_torch.sampling import samplers

try:
    import jax.numpy as jnp

    from chiaroscuro_tpu.sampling import prng as jprng
    from chiaroscuro_tpu.sampling import samplers as jsamplers
except ImportError:     # the card's machine: only the card tests run there
    jnp = jprng = jsamplers = None

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
    for got, want in zip(prng.raygen_streams(seed, torch.from_numpy(pix), torch.from_numpy(smp)),
                         (k0, k1, jx, jy)):
        assert torch.equal(got, want)
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


# ---------------------------------------------------------------------------
# The sample streams' kernels (ops/threefry_cuda.py).
# ---------------------------------------------------------------------------

EXTREMES = (0, 1, 2**31 - 1, 2**31, 2**32 - 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _keys(rows, dev):
    """(rows, 128) int64 keys holding uint32 words: random, with every pair
    of ``EXTREMES`` in the first 25 lanes."""
    k = np.random.default_rng(rows).integers(0, 2**32, (2, rows * 128), dtype=np.int64)
    ext = np.array(np.meshgrid(EXTREMES, EXTREMES, indexing="ij")).reshape(2, -1)
    k[:, :ext.shape[1]] = ext
    return tuple(torch.from_numpy(x).reshape(rows, 128).to(dev) for x in k)


def test_kernel_wrappers_reject_cpu_tensors():
    """The wrappers take CUDA tensors only; ``prng`` routes CPU tensors to
    the plain version, which launches nothing."""
    k = torch.zeros((2, 128), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        threefry_cuda.bounce_uniforms(k, k, 1, prng.N_BOUNCE_DIMS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        threefry_cuda.raygen(0, k, 0)
    before = dict(threefry_cuda.LAUNCHES)
    _assert_bitwise(prng.bounce_uniforms_planar(k, k, 1), prng.bounce_uniforms_plain(k, k, 1))
    for got, want in zip(prng.raygen_streams(0, k, 3), prng.raygen_streams_plain(0, k, 3)):
        _assert_bitwise(got, want)
    assert threefry_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_words(cuda_device):
    """A wrong dtype, a non-contiguous word, mismatched shapes or devices,
    and a bounce launch asked for other dims than the kernel writes."""
    k = torch.zeros((2, 256), dtype=torch.int64, device=cuda_device)
    dense, strided = k[:, :128].contiguous(), k[:, ::2]
    for args, match in (((dense.int(), dense), "dtype"), ((dense, dense.int()), "dtype"),
                        ((strided, strided), "contiguous"), ((dense, k), "shape")):
        with pytest.raises(ValueError, match=match):
            threefry_cuda.bounce_uniforms(*args, 1, prng.N_BOUNCE_DIMS)
    with pytest.raises(RuntimeError, match="threefry_bounce launch failed"):
        threefry_cuda.bounce_uniforms(dense, dense, 1, prng.N_BOUNCE_DIMS - 1)
    for pix, smp, match in ((dense.int(), 0, "dtype"), (strided, 0, "contiguous"),
                            (dense, dense[0], "shape"), (dense, dense.int(), "dtype"),
                            (dense, torch.tensor(3), "CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            threefry_cuda.raygen(0, pix, smp)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4608])
@pytest.mark.parametrize("bounce", [*range(1, 9), 2**31])
def test_bounce_kernel_equals_int64_path(rows, bounce, cuda_device):
    """One launch a call, bitwise the int64 chain on the same card, from one
    row to Cornell's 589,824 lanes (4,608 rows)."""
    k0, k1 = _keys(rows, cuda_device)
    before = threefry_cuda.LAUNCHES["threefry_bounce"]
    got = prng.bounce_uniforms_planar(k0, k1, bounce)
    assert threefry_cuda.LAUNCHES["threefry_bounce"] == before + 1
    want = prng.bounce_uniforms_plain(k0, k1, bounce)
    assert want.shape == (prng.N_BOUNCE_DIMS, rows, 128)
    _assert_bitwise(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("sample", ["int", "scalar", "lanes"])
def test_raygen_kernel_equals_int64_path(sample, cuda_device):
    """Keys and jitter bitwise ``base_key`` + ``aa_jitter_pair`` on the same
    card, for a Python-int sample, a 0-dim tensor and one a lane."""
    g = np.random.default_rng(7)
    pix = torch.from_numpy(g.integers(0, 2**32, (36, 128), dtype=np.int64)).to(cuda_device)
    pix[0, :len(EXTREMES)] = torch.tensor(EXTREMES)
    smp = {"int": 2**31 + 5,
           "scalar": torch.tensor(2**32 - 1, dtype=torch.int64, device=cuda_device),
           "lanes": torch.from_numpy(g.integers(0, 2**32, (36, 128), dtype=np.int64)
                                     ).to(cuda_device)}[sample]
    for seed in (0, 2**32 + 7, 3000000077):
        before = threefry_cuda.LAUNCHES["threefry_raygen"]
        got = prng.raygen_streams(seed, pix, smp)
        assert threefry_cuda.LAUNCHES["threefry_raygen"] == before + 1
        k0, k1 = prng.base_key(seed, pix, smp)
        for x, y in zip(got, (k0, k1) + prng.aa_jitter_pair(k0, k1)):
            _assert_bitwise(x, y)


@pytest.mark.cuda
def test_captured_raygen_reads_sample_from_device(cuda_device):
    """A raygen launch captured in a CUDA graph draws, at each replay, the
    sample index written into its tensor since, not the captured one."""
    pix = (torch.arange(4 * 128, dtype=torch.int64, device=cuda_device) * 7919).reshape(4, 128)
    sample = torch.tensor(3, dtype=torch.int64, device=cuda_device)
    seed = 3000000077
    prng.raygen_streams(seed, pix, sample)         # the build and the module load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = threefry_cuda.LAUNCHES["threefry_raygen"]
    with torch.cuda.graph(graph):
        out = prng.raygen_streams(seed, pix, sample)
    assert threefry_cuda.LAUNCHES["threefry_raygen"] == before + 1
    for s in (3, 2**32 - 1, 12345):
        sample.fill_(s)
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(out, prng.raygen_streams_plain(seed, pix, s)):
            _assert_bitwise(x, y)
    assert threefry_cuda.LAUNCHES["threefry_raygen"] == before + 1
