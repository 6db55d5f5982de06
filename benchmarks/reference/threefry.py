"""Threefry-2x32 sample streams, frozen for the reference.

The stream layout the port's renders draw from, written out again so that
the reference computes every random number itself: stateless Threefry-2x32
blocks (20 rounds, the Random123 generator) over global counters,

    (k0, k1)      = threefry((0, seed),    (pixel_idx, sample_idx))
    jitter bits   = threefry((k0, k1),     (JITTER_TAG, 0))
    bounce-k bits = threefry((k0, k1),     (k, block))   block = 0..3

with 32-bit words held in int64 tensors, every ``+`` and ``<<`` masked to 32
bits.  Per bounce the seven uniforms are, in order: light pick, the light
point's two barycentrics, Russian roulette, the two disk coordinates of the
cosine sample, and the lobe pick.
"""

from __future__ import annotations

import torch

DIM_LIGHT_SEL, DIM_LIGHT_U, DIM_LIGHT_V, DIM_RR, DIM_BSDF_U, DIM_BSDF_V = range(6)
N_BOUNCE_DIMS = 7

JITTER_TAG = 0x51A77E12
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF


def _word(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _rotl(x, n):
    return ((x << n) & _M32) | (x >> (32 - n))


def threefry2x32(k0, k1, c0, c1):
    """(out0, out1) int64 tensors of uint32 values; broadcasts its words."""
    device = next((x.device for x in (k0, k1, c0, c1) if isinstance(x, torch.Tensor)), None)
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
    return x0, x1


def uniform(bits):
    """uint32 words -> float32 in [0, 1): 23 mantissa bits under exponent 0."""
    return (0x3F800000 | (bits >> 9)).to(torch.int32).view(torch.float32) - 1.0


def base_key(seed, pixel_idx, sample_idx):
    return threefry2x32(0, seed, pixel_idx, sample_idx)


def jitter(k0, k1):
    b0, b1 = threefry2x32(k0, k1, JITTER_TAG, 0)
    return uniform(b0), uniform(b1)


def bounce_uniforms(k0, k1, bounce):
    """(N_BOUNCE_DIMS, *k0.shape) float32 uniforms of path vertex ``bounce``;
    block b gives dims 2b and 2b + 1."""
    n_blocks = (N_BOUNCE_DIMS + 1) // 2
    blk = torch.arange(n_blocks, device=k0.device).reshape((n_blocks,) + (1,) * k0.dim())
    b0, b1 = threefry2x32(k0[None], k1[None], bounce, blk)
    bits = torch.stack([b0, b1], dim=1).reshape((2 * n_blocks,) + k0.shape)
    return uniform(bits[:N_BOUNCE_DIMS])
