"""Cluster (meshlet) intersection for large scenes: the cull K3, the
cluster visits K4/K5 (resident) and K6/K7 (streaming), their plain torch
versions, and the differentiable intersector pair the integrator calls.

The host side of ``chiaroscuro_tpu/ops/cluster_pallas.py``:

- ``cull`` is K3 (``_cull_rows`` :310): per 128-ray row, the exact per-lane
  slab test against every cluster box, reduced to each row's hit count and
  per-box sort keys (:func:`cull_sweep`: on a card ``csrc/cull_rows.cu``;
  plain :func:`_rowhit_scan`), then the stable near-ordered lists of
  :func:`_order_hits` (torch ops, as ``lax.sort`` on the TPU): meta (B0, 2)
  int32 [trip, overflow], ids (B0, Le) int32, nears (B0, Le) f32, cutoff
  (B0, 1) f32, Le = min(Lmax, K).
- ``cull_beam`` is K3b (``_cull_rows_beam`` :294, ``_rowhit_beam`` :226),
  the opt-in conservative cull: each row's origin and direction bounds
  against every box by interval arithmetic, and the same lists.  On a card
  one kernel (``csrc/cull_beam.cu``) sweeps a row's boxes into shared
  memory and selects its list there; plain, :func:`cull_beam_sweep_plain`
  (the same count and keys as K3's sweep) and :func:`_order_hits`.
- ``closest_resident`` is K4 (``_closest_kernel`` :485) and ``any_resident``
  K5 (``_any_kernel`` :550); ``closest_cluster`` is K6
  (``_stream_closest_kernel`` :627) and ``any_cluster`` K7
  (``_stream_any_kernel`` :750).  Each visits the listed clusters near to
  far with early exit, then sweeps all K clusters for overflow rows
  (``csrc/intersect_cluster.cu``, built by ``nvcc`` for ``sm_90a`` at first
  use, bound with ``ctypes``).  Each of the row's four warps walks the list
  on its own and votes its exit after every visit over its 32 lanes; the
  closest visit bulk-copies each block into the warp's own ring in shared
  memory, the occlusion visit reads it in place with an L1 prefetch.  On
  the card K4 and K6 are one kernel, and K5 and K7 one (the TPU's two pairs
  differ in where the matrix lives; a streaming fetch, one copy per
  row-visit by a producer warp, lost to the per-warp fetch at every size
  measured, PERF.md), so the routes differ only in the name their launches
  are counted under.  :func:`visit_counts_plain` replays the exit rule in
  torch, and every kernel counts its visits per warp, (B0, 4).
- :func:`make_cluster_intersectors` picks the pair by the JAX package's
  rule (:func:`streams_by_budget`) and exposes it as ``.route``
  (``"resident"`` or ``"stream"``).

K4/K5 compute the same function as K6/K7, so both pairs share one plain
torch version each: :func:`closest_cluster_plain` and
:func:`any_cluster_plain`.  Each wrapper takes its plain version only for
CPU tensors; for CUDA tensors it launches its kernel or raises — there is
no fallback.  ``LAUNCHES`` counts kernel launches.  The plain visits need no
early exit: the cluster results are exact by contract (the lexicographic
(t, original id) minimum over every hit, ``cluster_pallas.py:43-47``), so a
row's listed clusters (all K where it overflowed) give the same answer.

Gradients (``cluster_pallas.py:1158-1197``): :func:`closest_cluster_diff`
runs K4 or K6 forward and recomputes the winner's t, u, v and attribute
row from the original-order (T, 9) triangle rows and (T, 32) attribute
table in backward (:func:`~chiaroscuro_tpu_torch.ops.intersect_cuda.
closest_hit`), fetching them by a gather as ``cluster_pallas.py:1180``
does (the dense path's one-hot rule is not the cluster path's); the packed
matrix is built from detached geometry and gets no gradient, and occlusion
is a discrete decision taken on detached inputs.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from chiaroscuro_tpu_torch.accel.clusters import ClusterArrays, build_clusters
from chiaroscuro_tpu_torch.geometry.intersect import ClosestHit
from chiaroscuro_tpu_torch.ops.cuda_build import bind, check_launch
from chiaroscuro_tpu_torch.ops.intersect_cuda import (
    ATTR_K,
    BIG,
    LANE,
    _check,
    _gather_fetch,
    _launch_device,
    _mt_core,
    closest_hit,
    _prep_attrs,
    _prep_tris,
    row_major_pair,
    unpack_attrs_planar,
)

# Kernel launch counts, by kernel.  Incremented only where a wrapper
# launches its kernel; the plain versions never count.
LAUNCHES = {
    "cull": 0, "cull_beam": 0,                    # K3, K3b
    "closest_resident": 0, "any_resident": 0,     # K4, K5
    "closest_cluster": 0, "any_cluster": 0,       # K6, K7
}
# The two visit routes, by the kernels each launches: (closest, any).
ROUTES = {
    "resident": ("closest_resident", "any_resident"),
    "stream": ("closest_cluster", "any_cluster"),
}

# Clamp for 1/dir in the slab test: keeps axis-parallel rays finite (no
# 0 * inf NaNs) while behaving like +-inf for containment.
HUGE_INV = float(np.float32(1.0e30))
# The JAX package's packed block has PACK_W = 48 rows per cluster; its
# streaming rule is stated on that layout, and the port keeps the rule so
# both packages take the same route on the same scene (on the card both
# routes launch the same two kernels, under their own launch counts).
PACK_W = 48
RESIDENT_BUDGET_BYTES = 72 * 1024 * 1024
# Minimum cluster count for bounce compaction + spatial ray sorting
# (cluster_pallas.py:94-97, measured on the TPU).
COMPACT_MIN_K = 1024
# Candidate-list width (cluster_pallas.py:1064-1073).
DEFAULT_LMAX = 1536
# Triangle ids stay below 2^24, as in the JAX package (its ids ride as
# exact floats; lifting the limit would be a feature the reference lacks).
MAX_TRIS = 1 << 24
# Rows of the port's per-cluster block: v0 | e1 | e2 | original id (int32
# bits).  Padded slots hold zero triangles and id INT32_MAX.
GEO_ROWS = 10
NO_ID = int(np.iinfo(np.int32).max)

# Plain versions evaluate about this many (lane, box) or (lane, triangle)
# pairs at a time, so their memory stays O(pairs).
_PLAIN_PAIRS = 1 << 22
# Warps of a 128-lane row: the visit kernels walk and count per warp.
WARPS = 4


# ---------------------------------------------------------------------------
# K3: the cull.
# ---------------------------------------------------------------------------


def _safe_inv(d3):
    """Per-axis clamped 1/d for the slab test (``cluster_pallas.py:107``):
    (3, B0, 128) -> (3, B0, 128)."""
    mag = d3.abs()
    capped = torch.where(
        mag * HUGE_INV >= 1.0, 1.0 / torch.where(mag > 0, d3, 1.0), HUGE_INV
    )
    return torch.where(d3 < 0, -capped.abs(), capped.abs()).contiguous()


def _rowhit_scan(o3, inv, bmin, bmax, tmax=None):
    """Plain K3 sweep (``cluster_pallas.py:120``): ``(hit (B0, K) bool,
    entry (B0, K) f32)`` — does any lane of row b hit box k, and the min
    over hitting lanes of max(near, 0) (BIG where none).  A zero entry is
    +0.0 (``+ 0.0`` turns the -0.0 of an origin on a box plane into +0.0,
    as the kernel does: the card's radix sort orders -0.0 before +0.0).
    Chunked over K so nothing of size (K, B0, 128) is materialized."""
    K = bmin.shape[0]
    R = o3.shape[1] * LANE
    chunk = max(1, min(K, _PLAIN_PAIRS // max(R, 1)))
    hits, entries = [], []
    for base in range(0, K, chunk):
        cmn = bmin[base:base + chunk]
        cmx = bmax[base:base + chunk]
        near = far = None
        for a in range(3):
            t0 = (cmn[:, a, None, None] - o3[a][None]) * inv[a][None]
            t1 = (cmx[:, a, None, None] - o3[a][None]) * inv[a][None]
            lo = torch.minimum(t0, t1)
            hi = torch.maximum(t0, t1)
            near = lo if near is None else torch.maximum(near, lo)
            far = hi if far is None else torch.minimum(far, hi)
        hit = (far >= near) & (far >= 0.0)                 # (C, B0, 128)
        if tmax is not None:
            hit = hit & (near <= tmax[None])
        hits.append(hit.any(dim=2))
        entries.append(
            torch.where(hit, torch.clamp_min(near, 0.0) + 0.0, BIG).amin(dim=2)
        )
    return torch.cat(hits).T.contiguous(), torch.cat(entries).T.contiguous()


def _order_hits(count, key, Le):
    """Per-row hit counts (B0,) int32 and sort keys (B0, K) f32 (the entry
    where a box is hit, BIG where not) -> near-ascending (meta, ids, nears,
    cutoff) lists of width Le (``cluster_pallas.py:178``).

    A stable sort of the keys orders each row's hit boxes near to far, ties
    by box id.  Rows with more than Le hits keep the Le nearest (trip = Le,
    overflow = 1) and a cutoff = the entry of the first box left out; other
    rows carry cutoff = +inf."""
    B0, K = key.shape
    skey, sids = torch.sort(key, dim=1, stable=True)
    overflow = count > Le
    if K > Le:
        excl_entry = skey[:, Le]
    else:
        excl_entry = torch.full((B0,), BIG, dtype=torch.float32, device=key.device)
    ids = sids[:, :Le].to(torch.int32).contiguous()
    trip = torch.where(overflow, Le, count)
    meta = torch.stack([trip, overflow.to(torch.int32)], dim=1)
    cutoff = torch.where(overflow, excl_entry, float("inf"))
    return meta, ids, skey[:, :Le].contiguous(), cutoff[:, None].contiguous()


def cull_sweep_plain(o3, d3, bmin, bmax, tmax=None):
    """Plain torch K3 sweep: same inputs and outputs as :func:`cull_sweep`
    (the hit mask always)."""
    hit, entry = _rowhit_scan(o3, _safe_inv(d3), bmin, bmax, tmax)
    return hit.sum(dim=1, dtype=torch.int32), torch.where(hit, entry, BIG), hit


@functools.cache
def build_cull() -> tuple:
    """Build and load ``csrc/cull_rows.cu`` (``ops/cuda_build.py``);
    returns ``(lib, info)``.  A failed build raises."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return bind("cull_rows", {"cull_rows_launch": [vp] * 5 + [ci, ci] + [vp] * 4})


def cull_sweep(o3, d3, bmin, bmax, tmax=None, hits=False):
    """K3's sweep: per 128-ray row, the exact per-lane slab test against
    every box, reduced over the row's lanes.

    o3, d3: (3, B0, 128) f32; bmin, bmax: (K, 3) f32 boxes; tmax: None or
    (B0, 128) f32 (then a box counts only where near <= tmax).  Returns
    (count (B0,) int32 hit boxes a row, key (B0, K) f32 = the entry where
    hit else BIG, hit (B0, K) bool or None): the kernel writes the hit mask
    only when ``hits`` (the lists need count and key alone).  With K = 0
    there is no box to test: count is zero, key and hit have no column, and
    nothing is launched (on either device).  On CUDA
    tensors it launches ``csrc/cull_rows.cu`` (built by ``nvcc`` for
    ``sm_90a`` at first use, bound with ``ctypes``) and counts it in
    ``LAUNCHES["cull"]``, or raises; on CPU tensors it takes
    :func:`cull_sweep_plain`.  The inputs are taken detached."""
    o3, d3 = o3.detach(), d3.detach()
    if tmax is not None:
        tmax = tmax.detach()
    device = _launch_device(o3, d3, bmin, bmax)
    B0 = o3.shape[1]
    K = bmin.shape[0]
    _check("o3", o3, (3, B0, LANE), torch.float32, device)
    _check("d3", d3, (3, B0, LANE), torch.float32, device)
    _check("bmin", bmin, (K, 3), torch.float32, device)
    _check("bmax", bmax, (K, 3), torch.float32, device)
    if tmax is not None:
        _check("tmax", tmax, (B0, LANE), torch.float32, device)
    if K == 0:
        return (torch.zeros((B0,), dtype=torch.int32, device=device),
                torch.empty((B0, 0), dtype=torch.float32, device=device),
                torch.empty((B0, 0), dtype=torch.bool, device=device) if hits else None)
    if device.type == "cpu":
        return cull_sweep_plain(o3, d3, bmin, bmax, tmax)
    if bmin.data_ptr() % 16 or bmax.data_ptr() % 16:
        raise ValueError("bmin and bmax must be 16-byte aligned")
    lib, _ = build_cull()
    key = torch.empty((B0, K), dtype=torch.float32, device=device)
    count = torch.empty((B0,), dtype=torch.int32, device=device)
    hit = torch.empty((B0, K), dtype=torch.bool, device=device) if hits else None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.cull_rows_launch(
            o3.data_ptr(), d3.data_ptr(), None if tmax is None else tmax.data_ptr(),
            bmin.data_ptr(), bmax.data_ptr(), B0, K, key.data_ptr(),
            count.data_ptr(), None if hit is None else hit.data_ptr(), stream,
        )
    check_launch(lib, err, "cull")
    LAUNCHES["cull"] += 1
    return count, key, hit


def cull_plain(o3, d3, bmin, bmax, Le, tmax=None):
    """Plain torch K3: same inputs and outputs as :func:`cull`."""
    return _order_hits(*cull_sweep_plain(o3, d3, bmin, bmax, tmax)[:2], Le)


def cull(o3, d3, bmin, bmax, Le, tmax=None):
    """K3: per-row cluster cull (``cluster_pallas.py:310``).

    o3, d3: (3, B0, 128) f32; bmin, bmax: (K, 3) f32 boxes; tmax: None or
    (B0, 128) f32 (then a box counts only where near <= tmax).  Returns
    (meta, ids, nears, cutoff) as in :func:`_order_hits`: the sweep
    (:func:`cull_sweep`), then the stable sort.  The lists only steer the
    visits, so the inputs are taken detached."""
    K = bmin.shape[0]
    if not 1 <= Le <= K:
        raise ValueError(f"list width Le={Le} must lie in [1, K={K}]")
    count, key, _ = cull_sweep(o3, d3, bmin, bmax, tmax)
    return _order_hits(count, key, Le)


# ---------------------------------------------------------------------------
# K3b: the beam cull.
# ---------------------------------------------------------------------------


def cull_beam_sweep_plain(o3, d3, bmin, bmax, tmax=None):
    """Plain torch K3b sweep: the JAX package's ``_rowhit_beam``
    (``cluster_pallas.py:226``) op for op.  Per row, the lane min/max of
    origin and direction on each axis; on the ``definite`` axes (the row's
    directions all of one sign) the interval of each box plane's t from the
    four endpoint products of [plane - O_hi, plane - O_lo] and the
    reciprocals' [q_lo, q_hi]; ``near_lo`` the max over axes of the planes'
    lower ends (from -BIG), ``far_hi`` the min of their upper ends (from
    BIG); ``hit = far_hi >= near_lo and far_hi >= 0`` (and, with ``tmax``,
    ``near_lo <=`` the row's largest tmax).  Returns :func:`cull_sweep`'s
    count (B0,) int32 and key (B0, K) f32: max(near_lo, 0) + 0.0 where hit
    (+0.0 as K3's), BIG where not.  Chunked over K so that the (B0, K)
    temporaries stay O(_PLAIN_PAIRS)."""
    B0, K = o3.shape[1], bmin.shape[0]
    bounds = []
    for a in range(3):
        d_lo, d_hi = d3[a].amin(dim=1), d3[a].amax(dim=1)
        definite = (d_lo > 0.0) | (d_hi < 0.0)                     # (B0,)
        i_lo = 1.0 / torch.where(definite, d_lo, 1.0)
        i_hi = 1.0 / torch.where(definite, d_hi, 1.0)
        bounds.append((o3[a].amin(dim=1)[:, None], o3[a].amax(dim=1)[:, None],
                       torch.minimum(i_lo, i_hi)[:, None],
                       torch.maximum(i_lo, i_hi)[:, None], definite[:, None]))

    def t_interval(plane, o_lo, o_hi, q_lo, q_hi):
        p_lo, p_hi = plane[None, :] - o_hi, plane[None, :] - o_lo
        t1, t2, t3, t4 = p_lo * q_lo, p_lo * q_hi, p_hi * q_lo, p_hi * q_hi
        return (torch.minimum(torch.minimum(t1, t2), torch.minimum(t3, t4)),
                torch.maximum(torch.maximum(t1, t2), torch.maximum(t3, t4)))

    t_row = None if tmax is None else tmax.amax(dim=1)[:, None]
    chunk = max(1, min(K, _PLAIN_PAIRS // max(B0, 1)))
    counts, keys = torch.zeros((B0,), dtype=torch.int32, device=o3.device), []
    for base in range(0, K, chunk):
        near_lo = torch.full((B0, 1), -BIG, dtype=torch.float32, device=o3.device)
        far_hi = torch.full((B0, 1), BIG, dtype=torch.float32, device=o3.device)
        for a, (o_lo, o_hi, q_lo, q_hi, definite) in enumerate(bounds):
            tn_lo, tn_hi = t_interval(bmin[base:base + chunk, a], o_lo, o_hi, q_lo, q_hi)
            tf_lo, tf_hi = t_interval(bmax[base:base + chunk, a], o_lo, o_hi, q_lo, q_hi)
            near_lo = torch.maximum(near_lo, torch.where(definite, torch.minimum(tn_lo, tf_lo), -BIG))
            far_hi = torch.minimum(far_hi, torch.where(definite, torch.maximum(tn_hi, tf_hi), BIG))
        hit = (far_hi >= near_lo) & (far_hi >= 0.0)
        if t_row is not None:
            hit = hit & (near_lo <= t_row)
        counts += hit.sum(dim=1, dtype=torch.int32)
        keys.append(torch.where(hit, torch.clamp_min(near_lo, 0.0) + 0.0, BIG))
    key = torch.cat(keys, dim=1) if keys else o3.new_empty((B0, 0))
    return counts, key.contiguous()


@functools.cache
def build_cull_beam() -> tuple:
    """Build and load ``csrc/cull_beam.cu`` (``ops/cuda_build.py``);
    returns ``(lib, info)``.  A failed build raises.  The library also
    exports the two-step cull's sweep (``cull_beam_sweep_launch``: the
    (B0, K) keys for :func:`_order_hits`), which ``chip_smoke.py`` times
    beside :func:`cull_beam`; the port never calls it."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib, info = bind("cull_beam", {
        "cull_beam_launch": [vp] * 5 + [ci, ci, ci] + [vp] * 5,
        "cull_beam_sweep_launch": [vp] * 5 + [ci, ci] + [vp] * 3,
    })
    lib.cull_beam_smem_bytes.argtypes, lib.cull_beam_smem_bytes.restype = [ci, ci], ci
    lib.cull_beam_smem_limit.argtypes, lib.cull_beam_smem_limit.restype = [], ci
    return lib, info


def cull_beam_plain(o3, d3, bmin, bmax, Le, tmax=None):
    """Plain torch K3b: same inputs and outputs as :func:`cull_beam` (the
    plain sweep, then the stable sort of :func:`_order_hits`)."""
    return _order_hits(*cull_beam_sweep_plain(o3, d3, bmin, bmax, tmax), Le)


def cull_beam(o3, d3, bmin, bmax, Le, tmax=None):
    """K3b: the conservative per-row beam cull (``_cull_rows_beam``,
    ``cluster_pallas.py:294``), :func:`cull`'s inputs and (meta, ids,
    nears, cutoff), equal to :func:`cull_beam_plain`'s.  Its lists hold
    every box K3's hold (and more), with lower entries, so the visits'
    results do not change; the inputs are taken detached.

    On CUDA tensors one kernel (``csrc/cull_beam.cu``, built by ``nvcc``
    for ``sm_90a`` at first use, bound with ``ctypes``) sweeps each row's
    boxes into shared memory and selects its Le + 1 nearest there
    (``csrc/row_select.cuh``): no (B0, K) tensor and no sort.  It is
    counted in ``LAUNCHES["cull_beam"]``; a row's K keys and its list must
    fit in a block's shared memory (K up to 53,952 at Le = 1,536 on an
    H100), else it raises ValueError, and a failed launch raises.  On CPU
    tensors it takes :func:`cull_beam_plain`."""
    K = bmin.shape[0]
    if not 1 <= Le <= K:
        raise ValueError(f"list width Le={Le} must lie in [1, K={K}]")
    o3, d3 = o3.detach(), d3.detach()
    if tmax is not None:
        tmax = tmax.detach()
    device = _launch_device(o3, d3, bmin, bmax)
    B0 = o3.shape[1]
    _check("o3", o3, (3, B0, LANE), torch.float32, device)
    _check("d3", d3, (3, B0, LANE), torch.float32, device)
    _check("bmin", bmin, (K, 3), torch.float32, device)
    _check("bmax", bmax, (K, 3), torch.float32, device)
    if tmax is not None:
        _check("tmax", tmax, (B0, LANE), torch.float32, device)
    if device.type == "cpu":
        return cull_beam_plain(o3, d3, bmin, bmax, Le, tmax)
    lib, _ = build_cull_beam()
    with torch.cuda.device(device):
        need, have = lib.cull_beam_smem_bytes(K, Le), lib.cull_beam_smem_limit()
        if need > have:
            raise ValueError(
                f"K3b keeps a row's K={K} keys and its list of Le + 1 = {Le + 1} in shared "
                f"memory: {need} bytes, above the {have} a block of this card may take")
        meta = torch.empty((B0, 2), dtype=torch.int32, device=device)
        ids = torch.empty((B0, Le), dtype=torch.int32, device=device)
        nears = torch.empty((B0, Le), dtype=torch.float32, device=device)
        cutoff = torch.empty((B0, 1), dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.cull_beam_launch(
            o3.data_ptr(), d3.data_ptr(), None if tmax is None else tmax.data_ptr(),
            bmin.data_ptr(), bmax.data_ptr(), B0, K, Le, meta.data_ptr(), ids.data_ptr(),
            nears.data_ptr(), cutoff.data_ptr(), stream,
        )
    check_launch(lib, err, "cull_beam")
    LAUNCHES["cull_beam"] += 1
    return meta, ids, nears, cutoff


# ---------------------------------------------------------------------------
# K4-K7: the visits.  Plain versions, shared by both routes.
# ---------------------------------------------------------------------------


def _row_clusters(meta, ids, b, K):
    """Cluster ids a plain visit of row b takes: the listed ones, or all K
    where the row overflowed."""
    if bool(meta[b, 1]):
        return torch.arange(K, device=ids.device)
    return ids[b, : int(meta[b, 0])].long()


def _tri_chunks(packed, cids):
    """Yield (v0, e1, e2, oid) of the clusters ``cids``: (C, 1) triangle
    columns and (C,) int32 original ids, C ~ _PLAIN_PAIRS / 128 at a time."""
    per = max(1, _PLAIN_PAIRS // (LANE * packed.shape[2]))
    for base in range(0, cids.numel(), per):
        blk = packed[cids[base:base + per]]                 # (n, 10, M)
        geo = blk.transpose(1, 2).reshape(-1, GEO_ROWS)     # (n*M, 10)
        cols = tuple(geo[:, c:c + 1] for c in range(9))
        oid = geo[:, 9].contiguous().view(torch.int32)
        yield cols[0:3], cols[3:6], cols[6:9], oid


def closest_cluster_plain(meta, ids, nears, cutoff, o3, d3, packed, attrs):
    """Plain torch K4/K6: same inputs and outputs as
    :func:`closest_resident` and :func:`closest_cluster`.  ``nears`` and
    ``cutoff`` only steer the kernels' early exit, which the plain version
    does without."""
    B0 = o3.shape[1]
    K = packed.shape[0]
    best_t, best_id, best_u, best_v = _closest_init((B0, LANE), o3.device)
    for b in range(B0):
        o = tuple(o3[a, b][None] for a in range(3))          # (1, 128)
        d = tuple(d3[a, b][None] for a in range(3))
        best = best_t[b], best_id[b], best_u[b], best_v[b]
        for v0, e1, e2, oid in _tri_chunks(packed, _row_clusters(meta, ids, b, K)):
            ok, t, u, v = _mt_core(o, d, v0, e1, e2)         # (C, 128)
            best = _merge_closest(best, ok, t, u, v, oid[:, None], 0)
        best_t[b], best_id[b], best_u[b], best_v[b] = best
    return _closest_out(best_t, best_id, best_u, best_v, attrs)


def _closest_init(shape, device):
    """Running (t, id, u, v) before any hit: BIG, NO_ID, 0, 0."""
    return (torch.full(shape, BIG, dtype=torch.float32, device=device),
            torch.full(shape, NO_ID, dtype=torch.int32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def _merge_closest(best, ok, t, u, v, oid, dim):
    """Fold tests into the running (t, id, u, v): the lexicographic (t,
    original id) minimum over the valid hits (ok and t < BIG) along ``dim``
    of ok/t/u/v, ``oid`` the tests' ids broadcast against them.  Order-free,
    so any grouping of the visits gives the kernels' answer."""
    bt, bi, bu, bv = best
    valid = ok & (t < BIG)
    tm = torch.where(valid, t, BIG)
    at_min = valid & (tm == tm.amin(dim=dim, keepdim=True))
    idsel = torch.where(at_min, oid, NO_ID).amin(dim=dim, keepdim=True)
    # One-hot per lane (ids are unique); the winner's own t, u, v.
    sel = at_min & (oid == idsel)
    pos = sel.to(torch.int8).argmax(dim=dim, keepdim=True)
    ct = t.gather(dim, pos).squeeze(dim)
    idsel = idsel.squeeze(dim)
    better = sel.any(dim=dim) & ((ct < bt) | ((ct == bt) & (idsel < bi)))
    return (torch.where(better, ct, bt), torch.where(better, idsel, bi),
            torch.where(better, u.gather(dim, pos).squeeze(dim), bu),
            torch.where(better, v.gather(dim, pos).squeeze(dim), bv))


def _closest_out(best_t, best_id, best_u, best_v, attrs):
    """(t, id, u, v, attrs_out) of the kernels from the final running best:
    a miss keeps t = BIG and gets id 0 and zero attributes."""
    B0 = best_t.shape[0]
    hit = best_t < BIG
    tid = torch.where(hit, best_id, 0)
    am = torch.where(hit.reshape(-1, 1), attrs[tid.reshape(-1).long()], 0.0)
    return (
        best_t, tid, best_u, best_v,
        am.T.reshape(ATTR_K, B0, LANE).contiguous(),
    )


def any_cluster_plain(meta, ids, nears, cutoff, o3, d3, tmax, excl, packed):
    """Plain torch K5/K7: same inputs and outputs as :func:`any_resident`
    and :func:`any_cluster`."""
    B0 = o3.shape[1]
    K = packed.shape[0]
    occ = torch.zeros((B0, LANE), dtype=torch.bool, device=o3.device)
    for b in range(B0):
        o = tuple(o3[a, b][None] for a in range(3))
        d = tuple(d3[a, b][None] for a in range(3))
        row = occ[b]
        for v0, e1, e2, oid in _tri_chunks(packed, _row_clusters(meta, ids, b, K)):
            ok, t, _, _ = _mt_core(o, d, v0, e1, e2)
            blocking = ok & (t < tmax[b][None]) & (oid[:, None] != excl[b][None])
            row = row | blocking.any(dim=0)
        occ[b] = row
    return occ


def _visit_walk(meta, ids, nears, cutoff, o3, d3, packed, tmax=None, excl=None,
                lanes=LANE // WARPS, results=False):
    """The visit kernels' walks replayed in torch, group by group of
    ``lanes`` lanes of a row (32: K4-K7, each warp on its own; 128: the
    whole row walking together, the rule the per-row bound counts).  A
    group visits the listed clusters in order while a
    vote after every visit finds a lane that can still improve (closest:
    best t >= the next near; occlusion: an open lane with tmax >= it), then
    sweeps all K clusters in identity order while one reaches the cutoff.
    ``tmax``/``excl`` None means a closest query.

    Returns (visits (B0, 128 // lanes) int32 clusters each group visited,
    tests (B0, 128 // lanes) int64, state).  ``tests`` counts each group's
    (lane, triangle) tests the visits needed: closest every lane against
    every triangle of a visited block, occlusion each open lane up to and
    including its first blocker in the visit order.  Groups walk apart, so
    a row's counts do not depend on the other rows given.  ``state`` is the occlusion (B0, 128) bool, or for a
    closest query the best t (B0, 128) and, with ``results``, the whole
    running (t, id, u, v)."""
    B0 = o3.shape[1]
    G = LANE // lanes
    U = B0 * G
    K, _, M = packed.shape
    Le = ids.shape[1]
    dev = o3.device
    row = torch.arange(U, device=dev) // G
    trip = meta[:, 0].long()[row]
    cut = cutoff[:, 0][row, None]
    o, d = o3.reshape(3, U, lanes), d3.reshape(3, U, lanes)
    if tmax is None:
        state = list(_closest_init((U, lanes), dev)[:4 if results else 1])

        def wants(units, bound):
            return state[0][units] >= bound
    else:
        tm, ex = tmax.reshape(U, lanes), excl.reshape(U, lanes)
        occ = torch.zeros((U, lanes), dtype=torch.bool, device=dev)

        def wants(units, bound):
            return ~occ[units] & (tm[units] >= bound)
    visits = torch.zeros(U, dtype=torch.int64, device=dev)
    pos = torch.zeros(U, dtype=torch.int64, device=dev)
    sweeping = torch.zeros(U, dtype=torch.bool, device=dev)   # in phase 2
    live = torch.ones(U, dtype=torch.bool, device=dev)
    tests = torch.zeros(U, dtype=torch.int64, device=dev)
    tri = torch.arange(M, device=dev)[None, :, None]
    per = max(1, _PLAIN_PAIRS // (M * lanes))
    while True:
        units = torch.nonzero(live).reshape(-1)
        if units.numel() == 0:
            break
        # Each live group's vote before its next visit: phase 1 while its
        # list lasts and the vote holds, else phase 2 from cluster 0.
        p, r, in2 = pos[units], row[units], sweeping[units]
        near = nears[r, torch.clamp_max(p, Le - 1)][:, None]
        go1 = ~in2 & (p < trip[units]) & wants(units, near).any(dim=1)
        p = torch.where(in2 | go1, p, 0)
        in2 = ~go1
        go = go1 | (in2 & (p < K) & wants(units, cut[units]).any(dim=1))
        sweeping[units] = in2
        live[units] = go
        units, p, go1, r = units[go], p[go], go1[go], r[go]
        pos[units] = p + 1
        visits[units] += 1
        cids = torch.where(go1, ids[r, torch.clamp_max(p, Le - 1)].long(), p)
        for base in range(0, units.numel(), per):
            us = units[base:base + per]
            blk = packed[cids[base:base + per]]                    # (A, 10, M)
            cols = tuple(blk[:, c, :, None] for c in range(9))     # (A, M, 1)
            oid = blk[:, 9].contiguous().view(torch.int32)[:, :, None]
            ok, t, u, v = _mt_core(tuple(o[a, us][:, None] for a in range(3)),
                                   tuple(d[a, us][:, None] for a in range(3)),
                                   cols[0:3], cols[3:6], cols[6:9])  # (A, M, lanes)
            if tmax is None:
                tests[us] += M * lanes
                if results:
                    merged = _merge_closest(tuple(s[us] for s in state),
                                            ok, t, u, v, oid, 1)
                    for s, x in zip(state, merged):
                        s[us] = x
                else:
                    hit_t = torch.where(ok & (t < BIG), t, BIG).amin(dim=1)
                    state[0][us] = torch.minimum(state[0][us], hit_t)
            else:
                blocking = ok & (t < tm[us][:, None]) & (oid != ex[us][:, None])
                first = torch.where(blocking, tri, M).amin(dim=1)   # (A, lanes)
                was = occ[us]
                tests[us] += torch.where(was, 0, torch.clamp_max(first + 1, M)).sum(1)
                occ[us] = was | (first < M)
    visits, tests = visits.to(torch.int32).reshape(B0, G), tests.reshape(B0, G)
    if tmax is not None:
        return visits, tests, occ.reshape(B0, LANE)
    return visits, tests, tuple(s.reshape(B0, LANE) for s in state)


def visit_counts_plain(meta, ids, nears, cutoff, o3, d3, packed, tmax=None,
                       excl=None, lanes=LANE // WARPS):
    """Clusters visited by each group of ``lanes`` lanes under the exit
    rule (:func:`_visit_walk`): (B0, 4) int32 per warp as the visit kernels
    K4-K7 count them (``lanes`` 32); (B0, 1) per row with ``lanes`` 128,
    the rule of a row walking together (the per-row bound in PERF.md).
    ``tmax``/``excl`` None means the closest query, else occlusion."""
    return _visit_walk(meta, ids, nears, cutoff, o3, d3, packed, tmax, excl,
                       lanes)[0]


# ---------------------------------------------------------------------------
# K4-K7: build, bind and launch.
# ---------------------------------------------------------------------------


@functools.cache
def build() -> tuple:
    """Build and load ``csrc/intersect_cluster.cu`` (``ops/cuda_build.py``);
    returns ``(lib, info)`` as :func:`~chiaroscuro_tpu_torch.ops.
    intersect_cuda.build` does.  A failed build raises."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return bind("intersect_cluster", {
        # The closest visits (K4 and K6) and the occlusion visits (K5, K7).
        "closest_visits_launch": [vp] * 8 + [ci] * 4 + [vp] * 7,
        "any_visits_launch": [vp] * 9 + [ci] * 4 + [vp] * 3,
        # Not a launch: the closest visits' dynamic shared memory (bytes) a
        # block at a given M.
        "closest_visits_smem_bytes": [ci],
    })


def _check_lists(meta, ids, nears, cutoff, o3, d3, packed, device):
    """Shapes, types and layout the visit kernels take; returns (B0, Le)."""
    B0 = o3.shape[1]
    Le = ids.shape[1] if ids.dim() == 2 else -1
    K, rows, M = packed.shape if packed.dim() == 3 else (0, 0, 0)
    _check("meta", meta, (B0, 2), torch.int32, device)
    _check("ids", ids, (B0, Le), torch.int32, device)
    _check("nears", nears, (B0, Le), torch.float32, device)
    _check("cutoff", cutoff, (B0, 1), torch.float32, device)
    _check("o3", o3, (3, B0, LANE), torch.float32, device)
    _check("d3", d3, (3, B0, LANE), torch.float32, device)
    _check("packed", packed, (K, GEO_ROWS, M), torch.float32, device)
    if not (1 <= Le <= K and M % 4 == 0 and 0 < M <= 1024):
        raise ValueError(f"packed (K={K}, M={M}) with lists of width {Le}: "
                         "need 1 <= Le <= K and M a multiple of 4 up to 1024")
    return B0, Le


def _cpu_visits(visits, B0, replay):
    """Fill a CPU ``visits`` output, (B0, 4) int32, from the replay of the
    per-warp exit rule."""
    if visits is not None:
        _check("visits", visits, (B0, WARPS), torch.int32, visits.device)
        visits.copy_(replay())


def _visits_ptr(visits, B0, device):
    if visits is None:
        return None
    _check("visits", visits, (B0, WARPS), torch.int32, device)
    return visits.data_ptr()


def _no_grad_inputs(name, *tensors):
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise ValueError(
            f"{name} takes no gradient itself: use closest_cluster_diff (or "
            "the intersector pair), whose backward recomputes the hit from "
            "the original-order triangle rows"
        )


def _closest_visit(kernel, meta, ids, nears, cutoff, o3, d3, packed, attrs,
                   visits):
    """K4 (kernel ``closest_resident``) or K6 (``closest_cluster``)."""
    _no_grad_inputs(kernel, o3, d3, packed, attrs)
    device = _launch_device(o3, d3, packed, attrs)
    B0, Le = _check_lists(meta, ids, nears, cutoff, o3, d3, packed, device)
    _check("attrs", attrs, (attrs.shape[0], ATTR_K), torch.float32, device)
    if device.type == "cpu":
        _cpu_visits(visits, B0, lambda: visit_counts_plain(
            meta, ids, nears, cutoff, o3, d3, packed))
        return closest_cluster_plain(meta, ids, nears, cutoff, o3, d3, packed, attrs)
    visits_ptr = _visits_ptr(visits, B0, device)
    if packed.data_ptr() % 16 or attrs.data_ptr() % 16:
        raise ValueError("packed and attrs must be 16-byte aligned")
    lib, _ = build()
    K, _, M = packed.shape
    t = torch.empty((B0, LANE), dtype=torch.float32, device=device)
    tid = torch.empty((B0, LANE), dtype=torch.int32, device=device)
    u = torch.empty((B0, LANE), dtype=torch.float32, device=device)
    v = torch.empty((B0, LANE), dtype=torch.float32, device=device)
    am = torch.empty((ATTR_K, B0, LANE), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.closest_visits_launch(
            meta.data_ptr(), ids.data_ptr(), nears.data_ptr(),
            cutoff.data_ptr(), o3.data_ptr(), d3.data_ptr(), packed.data_ptr(),
            attrs.data_ptr(), B0, Le, K, M, t.data_ptr(),
            tid.data_ptr(), u.data_ptr(), v.data_ptr(), am.data_ptr(), visits_ptr,
            stream,
        )
    check_launch(lib, err, kernel)
    LAUNCHES[kernel] += 1
    return t, tid, u, v, am


def _any_visit(kernel, meta, ids, nears, cutoff, o3, d3, tmax, excl, packed,
               visits):
    """K5 (kernel ``any_resident``) or K7 (``any_cluster``)."""
    o3, d3, tmax = o3.detach(), d3.detach(), tmax.detach()
    device = _launch_device(o3, d3, tmax, packed)
    B0, Le = _check_lists(meta, ids, nears, cutoff, o3, d3, packed, device)
    _check("tmax", tmax, (B0, LANE), torch.float32, device)
    _check("excl", excl, (B0, LANE), torch.int32, device)
    if device.type == "cpu":
        _cpu_visits(visits, B0, lambda: visit_counts_plain(
            meta, ids, nears, cutoff, o3, d3, packed, tmax, excl))
        return any_cluster_plain(meta, ids, nears, cutoff, o3, d3, tmax, excl, packed)
    visits_ptr = _visits_ptr(visits, B0, device)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")
    lib, _ = build()
    K, _, M = packed.shape
    occ = torch.empty((B0, LANE), dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.any_visits_launch(
            meta.data_ptr(), ids.data_ptr(), nears.data_ptr(),
            cutoff.data_ptr(), o3.data_ptr(), d3.data_ptr(), tmax.data_ptr(),
            excl.data_ptr(), packed.data_ptr(), B0, Le, K, M,
            occ.data_ptr(), visits_ptr, stream,
        )
    check_launch(lib, err, kernel)
    LAUNCHES[kernel] += 1
    return occ


def closest_resident(meta, ids, nears, cutoff, o3, d3, packed, attrs,
                     visits=None):
    """K4: closest hit of each planar ray over the row's listed clusters,
    each of the row's four warps walking the list on its own and
    bulk-copying each visited block into its own ring in shared memory.

    meta/ids/nears/cutoff: the cull's lists (:func:`cull`); o3, d3:
    (3, B0, 128) f32; packed: (K, 10, M) f32 (:func:`derive_buffers`);
    attrs: (T, ATTR_K) f32 original-order table; visits: None or a
    (B0, 4) int32 tensor that receives each warp's cluster visit count (on
    the CPU from :func:`visit_counts_plain`).  Returns (t, id, u, v,
    attrs_out) as K1 does; a miss keeps t = BIG, id 0.  Takes no gradient:
    see :func:`closest_cluster_diff`."""
    return _closest_visit("closest_resident", meta, ids, nears, cutoff, o3,
                          d3, packed, attrs, visits)


def closest_cluster(meta, ids, nears, cutoff, o3, d3, packed, attrs,
                    visits=None):
    """K6, the streaming route's closest hit: on the card the same kernel
    as :func:`closest_resident` (the JAX package's streaming twin computes
    the same function), counted in ``LAUNCHES["closest_cluster"]``;
    ``visits`` as there, (B0, 4)."""
    return _closest_visit("closest_cluster", meta, ids, nears, cutoff, o3,
                          d3, packed, attrs, visits)


def any_resident(meta, ids, nears, cutoff, o3, d3, tmax, excl, packed,
                 visits=None):
    """K5: occlusion of each planar ray by a triangle of the row's listed
    clusters with id != excl at t < tmax, each warp walking on its own and
    reading each visited block in place.
    tmax: (B0, 128) f32; excl: (B0, 128) int32; visits as in
    :func:`closest_resident`.  Returns (B0, 128) bool; the inputs are taken
    detached."""
    return _any_visit("any_resident", meta, ids, nears, cutoff, o3, d3,
                      tmax, excl, packed, visits)


def any_cluster(meta, ids, nears, cutoff, o3, d3, tmax, excl, packed,
                visits=None):
    """K7, the streaming route's occlusion: on the card the same kernel as
    :func:`any_resident`, counted in ``LAUNCHES["any_cluster"]``;
    ``visits`` (B0, 4)."""
    return _any_visit("any_cluster", meta, ids, nears, cutoff, o3, d3, tmax,
                      excl, packed, visits)


def closest_cluster_diff(lists, o3, d3, tri_orig, attrs, packed, route):
    """Differentiable cluster closest hit (``cluster_pallas.py:1165-1197``):
    K4 (``route="resident"``) or K6 (``"stream"``) forward over the cull's
    ``lists``; backward recomputes the winner from ``tri_orig`` (T, 9) and
    ``attrs`` (T, ATTR_K), both in original triangle order, and gives
    ``packed`` and the lists no gradient."""
    kernel = ROUTES[route][0]

    def fwd(o3, d3, _tri_orig, attrs):
        return _closest_visit(kernel, *lists, o3, d3, packed, attrs, None)

    return closest_hit(fwd, o3, d3, tri_orig, attrs, fetch=_gather_fetch)


# ---------------------------------------------------------------------------
# Buffers and the intersector pair.
# ---------------------------------------------------------------------------


def derive_buffers(scene, clusters: ClusterArrays, tri_orig=None):
    """(packed (K, 10, M) f32, attrs (T, ATTR_K) f32) on the scene's device
    (``cluster_pallas.py:1105-1136``): each cluster's triangles field-major,
    v0|e1|e2 gathered from the scene in cluster order and the original id
    as int32 bits in row 9; padded slots zero with id INT32_MAX.

    ``tri_orig`` is the scene's original-order (T, 9) triangle rows where
    the caller has them (``_prep_tris``), else they are made here.
    ``packed`` is built from them detached: the kernels read it, and
    gradients go through the original-order ``attrs`` (not detached) and
    triangle rows instead (:func:`closest_cluster_diff`)."""
    dev = scene.device
    K, M, T = clusters.K, clusters.M, scene.n_tris
    oid = torch.from_numpy(np.asarray(clusters.orig_id, np.int32)).to(dev)
    real = oid < T
    if tri_orig is None:
        tri_orig = _prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    tri = tri_orig.detach()
    tri_perm = torch.where(real[:, None], tri[torch.clamp_max(oid, T - 1).long()], 0.0)
    geo = torch.cat([tri_perm, oid.view(torch.float32)[:, None]], dim=1)
    packed = geo.reshape(K, M, GEO_ROWS).transpose(1, 2).contiguous()
    return packed, _prep_attrs(scene)


def streams_by_budget(K: int, M: int) -> bool:
    """The JAX package's rule (``cluster_pallas.py:1078-1079``): stream the
    cluster blocks when the packed matrix exceeds the residency budget."""
    return K * M * PACK_W * 4 > RESIDENT_BUDGET_BYTES


def make_cluster_intersectors(
    scene,
    M: int = 128,
    Lmax: int | None = None,
    clusters: ClusterArrays | None = None,
    stream: bool | None = None,
    beam: bool | None = None,
):
    """Cluster-culled intersector pair for large scenes
    (``cluster_pallas.py:991``), speaking the same interface as
    :func:`~chiaroscuro_tpu_torch.ops.intersect_cuda.make_dense_intersectors`
    (whose ``live`` hints it ignores: parked rows cull to trip 0).

    The meshlet decomposition is built on the host from the scene's
    geometry unless ``clusters`` is given (a prebuilt ``ClusterArrays``,
    e.g. to rebuild the pair on a parameter-substituted scene without
    re-clustering, or the JAX package's ``build_clusters`` output read out
    as numpy).  ``Lmax`` is the list width (default 1536).  ``stream=None``
    applies the JAX package's rule (:func:`streams_by_budget`): the
    resident K4/K5 while the packed matrix is within 72 MiB, else the
    streaming K6/K7; ``stream=True``/``False`` forces a route on any scene.
    ``beam=True`` culls with K3b (:func:`cull_beam`, the conservative
    per-row test) in place of K3, for the closest and the occlusion query
    alike; ``beam=None`` reads ``CHIAROSCURO_BEAM_CULL`` (``1``/``true``
    turns it on) at each call, as ``cluster_pallas.py:1096`` does.  The
    results do not depend on the cull; only the lists' lengths do.

    The closest query is differentiable with respect to the rays and the
    scene's fields (:func:`closest_cluster_diff`); occlusion is not.  The
    pair carries ``route`` (``"resident"`` or ``"stream"``) and
    ``prefers_compaction`` / ``prefers_ray_sort`` (K >= 1024), which the
    renderer and integrator read, and ``beam``."""
    if beam is None:
        beam = os.environ.get("CHIAROSCURO_BEAM_CULL", "") in ("1", "true")
    cull_fn = cull_beam if beam else cull
    if clusters is None:
        clusters = build_clusters(
            scene.tri_v0.detach().cpu().numpy(),
            scene.tri_v1.detach().cpu().numpy(),
            scene.tri_v2.detach().cpu().numpy(), M,
        )
    M, K = clusters.M, clusters.K
    Le = min(DEFAULT_LMAX if Lmax is None else Lmax, K)
    if scene.n_tris >= MAX_TRIS:
        raise ValueError("cluster intersector supports < 2^24 triangles")
    if stream is None:
        stream = streams_by_budget(K, M)
    route = "stream" if stream else "resident"
    dev = scene.device
    bmin = torch.from_numpy(np.asarray(clusters.bbox_min, np.float32)).to(dev)
    bmax = torch.from_numpy(np.asarray(clusters.bbox_max, np.float32)).to(dev)
    tri_orig = _prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    packed, attrs = derive_buffers(scene, clusters, tri_orig)

    def closest_planar(o3, d3, live=None) -> ClosestHit:
        o3, d3 = o3.contiguous(), d3.contiguous()
        lists = cull_fn(o3, d3, bmin, bmax, Le)
        t, tid, u, v, am = closest_cluster_diff(
            lists, o3, d3, tri_orig, attrs, packed, route
        )
        return ClosestHit(t < BIG, t, tid, u, v, unpack_attrs_planar(am))

    def any_planar(o3, d3, tmax, excl, live=None):
        o3, d3 = o3.detach().contiguous(), d3.detach().contiguous()
        tmax = tmax.detach().contiguous()
        lists = cull_fn(o3, d3, bmin, bmax, Le, tmax=tmax)
        return _any_visit(
            ROUTES[route][1], *lists, o3, d3, tmax,
            excl.to(torch.int32).contiguous(), packed, None,
        )

    closest_fn, any_fn = row_major_pair(closest_planar, any_planar)
    closest_fn.route = any_fn.route = route
    closest_fn.beam = any_fn.beam = beam
    closest_fn.prefers_compaction = K >= COMPACT_MIN_K
    closest_fn.prefers_ray_sort = K >= COMPACT_MIN_K
    return closest_fn, any_fn
