"""K3, the cluster cull's slab sweep, as a Triton kernel.

Replaces the elementwise part of ``chiaroscuro_tpu/ops/cluster_pallas.py::
_cull_rows`` (``_rowhit_scan``, an XLA pass on the TPU): for every 128-ray
row b and cluster box k, the exact per-lane slab test

    t0, t1 = (bmin - o) * inv, (bmax - o) * inv        per axis
    near = max over axes of min(t0, t1), far = min over axes of max(t0, t1)
    hit = far >= near and far >= 0 [and near <= tmax]

reduced over the row's 128 lanes to ``hit[b, k]`` (any lane) and
``entry[b, k]`` = min over hitting lanes of max(near, 0) (BIG where none).
The stable near-ordered lists are then cut from these by
``ops/cluster_cuda.py::_order_hits`` with torch ops, as the JAX package cuts
them with ``lax.sort`` outside any kernel.

Design.  One program per (row, block of ``BLOCK_K`` boxes): a
(BLOCK_K, 128) tile of slab tests with the lanes as the reduced axis, the
row's rays and clamped reciprocals loaded once per program.  The kernel
masks box indices >= K itself (the JAX sweep pads with inverted boxes that
register hits and slices them off).  It takes the ``_safe_inv(d3)`` tensor
from its caller, so kernel and plain version divide identically; the rest,
(c - o) * inv, min/max and compares, has no multiply-add to contract, so the
outputs equal the plain version exactly.

What bounds it on an H100.  ~20 FP32 operations per (lane, box) pair and
one (B0, K) byte plus float written per row and box: at the 1280x720
atrium (B0 = 7,200, K = 3,760) 3.5 G pairs, ~70 GFLOP against ~135 MB
written, so it is arithmetic-bound; the tile keeps every operand in
registers.

This module imports no Triton at import time (the CPU tests import every
module); :func:`rowhit` compiles the kernel at its first call, with Triton's
cache under ``chiaroscuro_tpu_torch/_build/triton`` unless the caller set
``TRITON_CACHE_DIR``.
"""

import functools
import os

import torch

from chiaroscuro_tpu_torch.ops.cuda_build import BUILD_DIR

# triton.language, bound by _kernel() at first use so that importing this
# module needs no Triton; the kernel reads it as a global.
tl = None

BLOCK_K = 32
NUM_WARPS = 4

# The compiled kernel of each variant launched so far, keyed by whether it
# applies tmax (for build reports).
COMPILED = {}


@functools.cache
def _kernel():
    """The ``triton.jit`` kernel (imports Triton; compiled at first launch).

    ``tl`` is bound as a module global before the kernel is defined, so the
    kernel reads it as Triton's own kernels read theirs."""
    global tl
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD_DIR, "triton"))
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def cull_kernel(
        o_ptr, inv_ptr, tmax_ptr, bmin_ptr, bmax_ptr, hit_ptr, entry_ptr,
        n_rows, n_boxes,
        HAS_TMAX: tl.constexpr, BLOCK: tl.constexpr,
    ):
        row = tl.program_id(0)
        ks = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        kmask = ks < n_boxes
        lane = row * 128 + tl.arange(0, 128)
        plane = n_rows * 128

        ox = tl.load(o_ptr + lane)
        oy = tl.load(o_ptr + plane + lane)
        oz = tl.load(o_ptr + 2 * plane + lane)
        ix = tl.load(inv_ptr + lane)
        iy = tl.load(inv_ptr + plane + lane)
        iz = tl.load(inv_ptr + 2 * plane + lane)

        # Axis x, y, z in the plain version's order: near = max(max(lo_x, lo_y),
        # lo_z), far = min(min(hi_x, hi_y), hi_z).
        c0 = tl.load(bmin_ptr + ks * 3, mask=kmask, other=0.0)
        c1 = tl.load(bmax_ptr + ks * 3, mask=kmask, other=0.0)
        t0 = (c0[:, None] - ox[None, :]) * ix[None, :]
        t1 = (c1[:, None] - ox[None, :]) * ix[None, :]
        near = tl.minimum(t0, t1)
        far = tl.maximum(t0, t1)

        c0 = tl.load(bmin_ptr + ks * 3 + 1, mask=kmask, other=0.0)
        c1 = tl.load(bmax_ptr + ks * 3 + 1, mask=kmask, other=0.0)
        t0 = (c0[:, None] - oy[None, :]) * iy[None, :]
        t1 = (c1[:, None] - oy[None, :]) * iy[None, :]
        near = tl.maximum(near, tl.minimum(t0, t1))
        far = tl.minimum(far, tl.maximum(t0, t1))

        c0 = tl.load(bmin_ptr + ks * 3 + 2, mask=kmask, other=0.0)
        c1 = tl.load(bmax_ptr + ks * 3 + 2, mask=kmask, other=0.0)
        t0 = (c0[:, None] - oz[None, :]) * iz[None, :]
        t1 = (c1[:, None] - oz[None, :]) * iz[None, :]
        near = tl.maximum(near, tl.minimum(t0, t1))
        far = tl.minimum(far, tl.maximum(t0, t1))

        hit = (far >= near) & (far >= 0.0)
        if HAS_TMAX:
            tm = tl.load(tmax_ptr + lane)
            hit = hit & (near <= tm[None, :])
        anyhit = tl.max(hit.to(tl.int32), axis=1)
        entry = tl.min(tl.where(hit, tl.maximum(near, 0.0), 3.0e38), axis=1)
        out = row * n_boxes + ks
        tl.store(hit_ptr + out, anyhit.to(tl.uint8), mask=kmask)
        tl.store(entry_ptr + out, entry, mask=kmask)

    return cull_kernel


def rowhit(o3, inv, bmin, bmax, tmax=None):
    """Launch K3 on CUDA tensors: o3, inv (3, B0, 128) f32, bmin/bmax (K, 3)
    f32, tmax None or (B0, 128) f32, all contiguous on one device.  Returns
    ``(hit (B0, K) bool, entry (B0, K) f32)``.  Raises where the launch
    fails; the caller checks shapes and counts the launch."""
    B0 = o3.shape[1]
    K = bmin.shape[0]
    hit = torch.empty((B0, K), dtype=torch.uint8, device=o3.device)
    entry = torch.empty((B0, K), dtype=torch.float32, device=o3.device)
    if B0 == 0 or K == 0:
        return hit.view(torch.bool), entry
    if 3 * B0 * 128 >= 2**31 or B0 * K >= 2**31:
        raise ValueError(f"K3 indexes in int32: B0={B0}, K={K} is too large")
    kernel = _kernel()
    grid = (B0, -(-K // BLOCK_K))
    with torch.cuda.device(o3.device):
        COMPILED[tmax is not None] = kernel[grid](
            o3, inv, o3 if tmax is None else tmax, bmin, bmax, hit, entry,
            B0, K, HAS_TMAX=tmax is not None, BLOCK=BLOCK_K,
            num_warps=NUM_WARPS,
        )
    return hit.view(torch.bool), entry


def compile_report():
    """One line per compiled variant: registers, spills, shared memory."""
    return [
        f"cull_kernel HAS_TMAX={has_tmax}: "
        f"{getattr(ck, 'n_regs', 'n/a')} registers, "
        f"{getattr(ck, 'n_spills', 'n/a')} spills, "
        f"{getattr(getattr(ck, 'metadata', None), 'shared', 'n/a')} bytes shared"
        for has_tmax, ck in sorted(COMPILED.items())
    ]
