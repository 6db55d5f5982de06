"""X2: the double-buffered block fetch, the counterpart of
``tools/_tpu_dma_min.py`` (a minimal repro of a double-buffered DMA from
device memory with dynamic block ids, kernel ``kern``).

    python -m chiaroscuro_tpu_torch.tools.dma_min      # on the card

- :func:`dma_min` launches X2 (``csrc/dma_min.cu``, built by ``nvcc`` for
  ``sm_90a`` at first use, bound with ``ctypes``) on CUDA tensors and counts
  it in ``LAUNCHES``; on CPU tensors it takes :func:`dma_min_plain`.
- :func:`main` is the script: a seeded ``x`` of K blocks, trip = K, and the
  line ``ok <out.sum> <x.sum>``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from chiaroscuro_tpu_torch.ops.cuda_build import bind, check_launch
from chiaroscuro_tpu_torch.ops.intersect_cuda import _check, _launch_device

M, W, K = 128, 48, 16

# Kernel launches; incremented only where the wrapper launches X2.
LAUNCHES = {"dma_min": 0}


def dma_min_plain(meta, big):
    """Plain torch X2: (1, W) f32, the sum of blocks cid = min(j, n - 1) of
    ``big`` (n * M, W) for j < trip = ``meta[0, 0]`` (read to the host).

    Fixed order, the kernel's: within a block, rows 0..M-1 in turn (one add
    per row, over all visited blocks at once), then the block sums in visit
    order."""
    trip = int(meta[0, 0])
    n_blocks = big.shape[0] // M
    acc = torch.zeros((1, W), dtype=torch.float32, device=big.device)
    if trip <= 0:
        return acc
    cid = torch.clamp_max(torch.arange(trip, device=big.device), n_blocks - 1)
    blocks = big.reshape(n_blocks, M, W)[cid]               # (trip, M, W)
    s = torch.zeros_like(blocks[:, 0])
    for r in range(M):
        s = s + blocks[:, r]
    for j in range(trip):
        acc = acc + s[j]
    return acc


@functools.cache
def build() -> tuple:
    """Build and load ``csrc/dma_min.cu`` (``ops/cuda_build.py``); returns
    ``(lib, info)``.  A failed build raises."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return bind("dma_min", {"dma_min_launch": [vp, vp, ci, vp, vp]})


def dma_min(meta, big):
    """X2: :func:`dma_min_plain`'s function.  meta: (1, 2) int32 [trip, _];
    big: (n * M, W) f32, n >= 1 blocks of the repro's M x W = 128 x 48.  The
    kernel reads trip on the device (no host sync) and sums in the plain
    version's order, so the two are bitwise equal."""
    device = _launch_device(meta, big)
    n_blocks = big.shape[0] // M if big.dim() == 2 else 0
    if n_blocks < 1:
        raise ValueError(f"big {tuple(big.shape)} holds no block of {M} rows")
    _check("meta", meta, (1, 2), torch.int32, device)
    _check("big", big, (n_blocks * M, W), torch.float32, device)
    if device.type == "cpu":
        return dma_min_plain(meta, big)
    if big.data_ptr() % 16:
        raise ValueError("big must be 16-byte aligned")
    lib, _ = build()
    out = torch.empty((1, W), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dma_min_launch(meta.data_ptr(), big.data_ptr(), n_blocks,
                                 out.data_ptr(), stream)
    check_launch(lib, err, "dma_min")
    LAUNCHES["dma_min"] += 1
    return out


def main(device="cuda"):
    """The repro: x (K * M, W) uniform in [0, 1), seeded, trip = K;
    prints ``ok <out.sum> <x.sum>`` and returns (out, x).  Without a card,
    and without ``device="cpu"``, it raises."""
    dev = torch.device(device)
    x = torch.from_numpy(np.random.default_rng(0).random((K * M, W), np.float32)).to(dev)
    meta = torch.tensor([[K, 0]], dtype=torch.int32, device=dev)
    out = dma_min(meta, x)
    print("ok", float(out.sum()), float(x.sum()), flush=True)
    return out, x


if __name__ == "__main__":
    main()
