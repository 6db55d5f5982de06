"""The closest hit's backward row fetch: a sort-by-id segmented row sum,
``out[id] = sum of ct[:, lane] over the lanes whose tid is id``, the
backward of ``intersect_cuda._gather_fetch``.

:func:`scatter_rows_sum` sorts the ids stably with ``torch.sort`` and sums
the runs of equal ids with the kernels of ``csrc/scatter_rows.cu`` (its
header says what bounds them and what the design does about skewed ids):
a transpose of the planar cotangent into rows, then levels of fixed
32-item chunks, each completing the segments that lie inside a chunk and
passing the pieces of those that cross a chunk's edge to the next level
(:func:`level_sizes`).  No atomics: two runs give bitwise-equal tables.
The wrapper takes the plain torch version (:func:`scatter_rows_sum_plain`,
the same levels in the same order) only for CPU tensors; for CUDA tensors
it launches the kernels or raises.  ``LAUNCHES["scatter_rows"]`` counts
the sums run on the card (one transpose and one launch a level each).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from chiaroscuro_tpu_torch.ops.cuda_build import bind, check_launch

# Sums run by the kernels.  Incremented only where the wrapper launches
# them; the plain version never counts.
LAUNCHES = {"scatter_rows": 0}

# Items a chunk sums, at every level: one warp.  The plain version's levels
# repeat the kernel's only if this is its kChunk, which build() checks.
CHUNK = 32


def level_sizes(n: int) -> list:
    """The item count of each level of a sum over ``n`` lanes: each level
    but the last emits two slots a chunk; the last is one chunk."""
    sizes = [n]
    while sizes[-1] > CHUNK:
        sizes.append(2 * -(-sizes[-1] // CHUNK))
    return sizes


def _check_args(ct, tid, n_rows):
    """The device the sum runs on, after checking what the kernels take:
    ct (W, *tid.shape) f32 and tid int32, contiguous, on one device."""
    device = ct.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if tid.device != device:
        raise ValueError(f"tid is on {tid.device}, ct on {device}")
    if ct.dtype != torch.float32:
        raise ValueError(f"ct has dtype {ct.dtype}, expected torch.float32")
    if tid.dtype != torch.int32:
        raise ValueError(f"tid has dtype {tid.dtype}, expected torch.int32")
    if ct.dim() < 1 or tuple(ct.shape[1:]) != tuple(tid.shape):
        raise ValueError(f"ct has shape {tuple(ct.shape)}, expected (W, "
                         f"*{tuple(tid.shape)})")
    if not (ct.is_contiguous() and tid.is_contiguous()):
        raise ValueError("ct and tid must be contiguous")
    if n_rows < 0:
        raise ValueError(f"n_rows is {n_rows}")
    return device


def scatter_rows_sum(ct, tid, n_rows):
    """(n_rows, W) f32: row ``id`` sums ``ct[:, lane]`` over the lanes
    whose ``tid`` is ``id`` (0 where none does).  ct: (W, *tid.shape) f32,
    tid: int32 in [0, n_rows), both contiguous."""
    device = _check_args(ct, tid, n_rows)
    if device.type == "cpu":
        return scatter_rows_sum_plain(ct, tid, n_rows)
    keys, perm = torch.sort(tid.reshape(-1), stable=True)
    return _sum_sorted(ct, keys, perm, n_rows)


def _sum_sorted(ct, keys, perm, n_rows):
    """The kernels' part of :func:`scatter_rows_sum` on the card, from the
    stably sorted ids ``keys`` (int32) and their lanes ``perm`` (int64)."""
    device = ct.device
    W, N = ct.shape[0], keys.numel()
    out = torch.zeros((n_rows, W), dtype=torch.float32, device=device)
    if N == 0 or W == 0:
        return out
    lib, _ = build()
    vals = torch.empty((N, W), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.scatter_rows_transpose_launch(ct.data_ptr(), N, W, vals.data_ptr(),
                                                stream)
        check_launch(lib, err, "scatter_rows_transpose")
        flags = None
        sizes = level_sizes(N)
        for level, n in enumerate(sizes):
            nxt = sizes[level + 1] if level + 1 < len(sizes) else 0
            k_out = torch.empty((nxt,), dtype=torch.int32, device=device)
            f_out = torch.empty((nxt,), dtype=torch.int32, device=device)
            v_out = torch.empty((nxt, W), dtype=torch.float32, device=device)
            ptrs = [x.data_ptr() if nxt else None for x in (k_out, f_out, v_out)]
            err = lib.scatter_rows_sum_launch(
                int(level == 0), keys.data_ptr(), perm.data_ptr() if level == 0 else None,
                None if flags is None else flags.data_ptr(), vals.data_ptr(), n, W,
                out.data_ptr(), *ptrs, stream)
            check_launch(lib, err, "scatter_rows_sum")
            keys, flags, vals = k_out, f_out, v_out
    LAUNCHES["scatter_rows"] += 1
    return out


def scatter_rows_sum_plain(ct, tid, n_rows):
    """Plain torch :func:`scatter_rows_sum` (any device), in the kernels'
    order: the ids sorted stably, then :func:`level_sizes`' levels of
    CHUNK-item chunks, each piece summed in item order from 0.0."""
    W, N = ct.shape[0], tid.numel()
    out = ct.new_zeros((n_rows, W))
    if N == 0 or W == 0:
        return out
    keys, perm = torch.sort(tid.reshape(-1), stable=True)
    vals = ct.reshape(W, N).T[perm]                      # (N, W) in id order
    same = keys[1:] == keys[:-1]
    flags = F.pad(same, (1, 0)).int() | (F.pad(same, (0, 1)).int() << 1)
    for _ in level_sizes(N):
        keys, flags, vals = _plain_level(keys.int(), flags, vals, out)
    return out


def _plain_level(keys, flags, vals, out):
    """One level over (n,) keys (-1: an unused slot), flags (bit 0: the
    item's segment has items before it, bit 1: after) and (n, W) rows:
    whole segments stored in ``out``, the pieces that cross a chunk's edge
    returned as the next level's (keys, flags, rows), two slots a chunk."""
    n, W = vals.shape
    nc = -(-n // CHUNK)
    pad = nc * CHUNK - n
    K = F.pad(keys, (0, pad), value=-1).reshape(nc, CHUNK)
    Fl = F.pad(flags, (0, pad)).reshape(nc, CHUNK)
    V = F.pad(vals, (0, 0, 0, pad)).reshape(nc, CHUNK, W)
    slot_k = torch.full((2 * nc,), -1, dtype=torch.int32, device=keys.device)
    slot_f = torch.zeros((2 * nc,), dtype=torch.int32, device=keys.device)
    slot_v = vals.new_zeros((2 * nc, W))
    chunks = torch.arange(nc, device=keys.device)
    acc = vals.new_zeros((nc, W))
    cur = torch.full((nc,), -1, dtype=torch.int32, device=keys.device)
    left = torch.zeros_like(cur)
    right = torch.zeros_like(cur)

    def close(mask):
        whole = mask & (left == 0) & (right == 0)
        out[cur[whole].long()] = acc[whole]
        cross = mask & ~whole
        slot = 2 * chunks[cross] + (left[cross] == 0).long()
        slot_k[slot] = cur[cross]
        slot_f[slot] = left[cross] | (right[cross] << 1)
        slot_v[slot] = acc[cross]

    for j in range(CHUNK):
        k, f = K[:, j], Fl[:, j]
        real = k >= 0
        new = real & (k != cur)
        close(new & (cur >= 0))
        acc = torch.where(new[:, None], 0.0, acc)
        cur = torch.where(new, k, cur)
        left = torch.where(new, f & 1, left)
        right = torch.where(real, f >> 1, right)
        acc = torch.where(real[:, None], acc + V[:, j], acc)
    close(cur >= 0)
    return slot_k, slot_f, slot_v


@functools.cache
def build() -> tuple:
    """Build and load ``csrc/scatter_rows.cu`` (``ops/cuda_build.py``);
    returns ``(lib, info)``.  A failed build raises, and so does a library
    whose chunk is not :data:`CHUNK`."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib, info = bind("scatter_rows", {
        "scatter_rows_transpose_launch": [vp, cl, ci, vp, vp],
        "scatter_rows_sum_launch": [ci] + [vp] * 4 + [cl, ci] + [vp] * 5,
    })
    lib.scatter_rows_chunk.argtypes, lib.scatter_rows_chunk.restype = [], ci
    if lib.scatter_rows_chunk() != CHUNK:
        raise RuntimeError(f"csrc/scatter_rows.cu sums chunks of {lib.scatter_rows_chunk()} "
                           f"items, the plain version {CHUNK}")
    return lib, info
