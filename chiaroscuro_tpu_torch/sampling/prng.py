"""Counter-based PRNG streams, keyed on global (pixel, sample, bounce).

A bit-for-bit port of ``chiaroscuro_tpu/sampling/prng.py``: stateless
Threefry-2x32 blocks (20 rounds, the Random123 generator) evaluated over
*global* counters:

    (k0, k1)      = threefry((0, seed),    (pixel_idx, sample_idx))
    jitter bits   = threefry((k0, k1),     (JITTER_TAG, 0))
    bounce-k bits = threefry((k0, k1),     (k, block))   block = 0..3

Every random number is a pure function of (seed, global pixel index, sample
index, bounce index), so both packages draw the same numbers for the same
path and renders do not depend on how pixels or samples are batched.

torch has no full ``uint32`` arithmetic, so words live in ``int64`` tensors
holding values in [0, 2**32): every ``+`` and ``<<`` is masked back to 32
bits and ``>>`` acts on the masked (non-negative) value, which makes it the
logical shift Threefry needs.  That operator chain is the plain version
(``*_plain``, and the blocks below them), which CPU tensors take.  On CUDA
tensors the two call sites, :func:`raygen_streams` and
:func:`bounce_uniforms_planar`, are one kernel launch each
(``ops/threefry_cuda.py``), which keeps the words in uint32 registers and
gives the plain version's bits.

Per-bounce consumption layout (fixed, so streams never shift):

    dim 0: light selection u      (scene.cpp:79-82 uniform light pick)
    dim 1: light bary u0          (rayTracer.cpp:96)
    dim 2: light bary u1          (rayTracer.cpp:97, scaled by (1-u0))
    dim 3: russian roulette       (rayTracer.cpp:126)
    dim 4: bsdf concentric-disk x (brdf.cpp:20)
    dim 5: bsdf concentric-disk y (brdf.cpp:21)
    dim 6: diffuse-vs-specular lobe pick (Phong extension)
"""

from __future__ import annotations

import torch

from chiaroscuro_tpu_torch.ops import threefry_cuda

DIM_LIGHT_SEL = 0
DIM_LIGHT_U = 1
DIM_LIGHT_V = 2
DIM_RR = 3
DIM_BSDF_U = 4
DIM_BSDF_V = 5
DIM_LOBE = 6          # diffuse-vs-specular lobe pick (Phong extension)
N_BOUNCE_DIMS = 7

_JITTER_TAG = 0x51A77E12  # distinct from any bounce index

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _word(x, device):
    """A uint32 word: an integer tensor as an int64 tensor on ``device``, a
    Python int as a masked Python int.  A Python int stays a scalar of the
    arithmetic, so a block over tensor words copies nothing from the host
    (the renderer captures a pass as a CUDA graph, where such a copy cannot
    be recorded); int64 arithmetic with it gives the same bits as with the
    word held in a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _M32
    return int(x) & _M32


def _rotl(x, n: int):
    return ((x << n) & _M32) | (x >> (32 - n))


def threefry2x32(k0, k1, c0, c1):
    """One Threefry-2x32 block (20 rounds): (key0, key1, ctr0, ctr1) ->
    (out0, out1) as int64 tensors of uint32 values.  Elementwise over
    broadcastable words (Python ints or integer tensors)."""
    device = next(
        (x.device for x in (k0, k1, c0, c1) if isinstance(x, torch.Tensor)),
        None,
    )
    k0, k1, c0, c1 = (_word(x, device) for x in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT_A if i % 2 == 0 else _ROT_B:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return tuple(
        x if isinstance(x, torch.Tensor)
        else torch.tensor(x, dtype=torch.int64, device=device)
        for x in (x0, x1)
    )


def uniform_from_bits(bits):
    """uint32 words -> f32 in [0, 1): set the exponent for [1, 2), keep 23
    mantissa bits, subtract 1 (the standard bitcast construction)."""
    f = (0x3F800000 | (bits >> 9)).to(torch.int32).view(torch.float32)
    return f - 1.0


def base_key(seed, pixel_idx, sample_idx):
    """(k0, k1) for (pixel, sample) pairs; shapes follow ``pixel_idx``.
    ``pixel_idx`` is the *global* linear pixel index ``y * xres + x``."""
    return threefry2x32(0, seed, pixel_idx, sample_idx)


def aa_jitter_pair(k0, k1):
    """(jx, jy) stratified-AA jitters in [0,1) (``rayTracer.cpp:61``),
    each shaped like ``k0``."""
    b0, b1 = threefry2x32(k0, k1, _JITTER_TAG, 0)
    return uniform_from_bits(b0), uniform_from_bits(b1)


def raygen_streams(seed, pixel_idx, sample_idx):
    """(k0, k1, jx, jy): each sample's key (:func:`base_key`) and its AA
    jitter (:func:`aa_jitter_pair`), shaped like ``pixel_idx``.
    ``sample_idx`` is a Python int or an integer tensor, 0-dim or shaped
    like ``pixel_idx``.  On CUDA tensors (int64, contiguous) one kernel
    launch, which reads a tensor ``sample_idx`` from device memory: a
    captured pass draws the sample a replay writes there."""
    if not pixel_idx.is_cuda:
        return raygen_streams_plain(seed, pixel_idx, sample_idx)
    return threefry_cuda.raygen(seed, pixel_idx, sample_idx)


def raygen_streams_plain(seed, pixel_idx, sample_idx):
    """Plain torch :func:`raygen_streams` (any device)."""
    k0, k1 = base_key(seed, pixel_idx, sample_idx)
    return (k0, k1) + aa_jitter_pair(k0, k1)


def bounce_uniforms_planar(k0, k1, bounce):
    """(N_BOUNCE_DIMS, *B) uniforms for one path vertex, B = k0.shape;
    dims interleave as (block 0 word 0, block 0 word 1, ...).  On CUDA
    tensors one kernel launch."""
    if not k0.is_cuda:
        return bounce_uniforms_plain(k0, k1, bounce)
    return threefry_cuda.bounce_uniforms(k0, k1, bounce, N_BOUNCE_DIMS)


def bounce_uniforms_plain(k0, k1, bounce):
    """Plain torch :func:`bounce_uniforms_planar` (any device): the four
    Threefry blocks run as one batched evaluation over a leading block
    axis."""
    n_blocks = (N_BOUNCE_DIMS + 1) // 2
    blk = torch.arange(n_blocks, device=k0.device).reshape(
        (n_blocks,) + (1,) * k0.dim()
    )
    b0, b1 = threefry2x32(k0[None], k1[None], bounce, blk)
    bits = torch.stack([b0, b1], dim=1).reshape((2 * n_blocks,) + k0.shape)
    return uniform_from_bits(bits[:N_BOUNCE_DIMS])


# ---------------------------------------------------------------------------
# Row-major wrappers (tests, external callers).  A key is the (k0, k1) word
# pair stacked on the trailing axis: (..., 2) int64 holding uint32 values.
# ---------------------------------------------------------------------------


def pixel_sample_key(seed, pixel_idx, sample_idx) -> torch.Tensor:
    """(..., 2) key for (pixel, sample) pairs."""
    k0, k1 = base_key(seed, pixel_idx, sample_idx)
    return torch.stack(torch.broadcast_tensors(k0, k1), dim=-1)


def pixel_sample_keys(seed, pixel_idx, sample_idx) -> torch.Tensor:
    """(R, 2) keys for a batch of pixel indices."""
    return pixel_sample_key(seed, pixel_idx, sample_idx)


def aa_jitter(key) -> torch.Tensor:
    """(..., 2) key -> (..., 2) AA jitter in [0,1)."""
    jx, jy = aa_jitter_pair(key[..., 0], key[..., 1])
    return torch.stack([jx, jy], dim=-1)


def aa_jitter_batch(keys) -> torch.Tensor:
    return aa_jitter(keys)


def bounce_uniforms(key, bounce) -> torch.Tensor:
    """(N_BOUNCE_DIMS, ...) uniforms for one path vertex of each key."""
    return bounce_uniforms_planar(key[..., 0], key[..., 1], bounce)


def bounce_uniforms_batch(keys, bounce) -> torch.Tensor:
    """(R, N_BOUNCE_DIMS) uniforms for a wavefront of R rays at one bounce."""
    return torch.movedim(bounce_uniforms_planar(keys[..., 0], keys[..., 1], bounce), 0, -1)
