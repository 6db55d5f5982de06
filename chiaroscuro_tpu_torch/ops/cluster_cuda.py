"""Cluster (meshlet) intersection for large scenes: the cull K3, the
cluster visits K4/K5 (resident) and K6/K7 (streaming), their plain torch
versions, and the differentiable intersector pair the integrator calls.

The host side of ``chiaroscuro_tpu/ops/cluster_pallas.py``:

- ``cull`` is K3 (``_cull_rows`` :310): per 128-ray row, the exact per-lane
  slab test against every cluster box (:func:`_rowhit_scan`; on a card the
  Triton kernel of ``ops/cull_triton.py``), then the stable near-ordered
  lists of :func:`_order_hits` (torch ops, as ``lax.sort`` on the TPU):
  meta (B0, 2) int32 [trip, overflow], ids (B0, Le) int32, nears (B0, Le)
  f32, cutoff (B0, 1) f32, Le = min(Lmax, K).
- ``closest_resident`` is K4 (``_closest_kernel`` :485) and ``any_resident``
  K5 (``_any_kernel`` :550); ``closest_cluster`` is K6
  (``_stream_closest_kernel`` :627) and ``any_cluster`` K7
  (``_stream_any_kernel`` :750).  Each visits the listed clusters near to
  far with early exit, then sweeps all K clusters for overflow rows
  (``csrc/intersect_cluster.cu``, built by ``nvcc`` for ``sm_90a`` at first
  use, bound with ``ctypes``).  The resident pair reads each visited block
  straight from global memory (the matrix fits the card's L2 wherever the
  JAX rule picks it) and votes on the early exit once per 8 visits; the
  streaming pair stages each block through shared memory.
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
closest_hit`); the packed matrix is built from detached geometry and gets
no gradient, and occlusion is a discrete decision taken on detached inputs.
"""

from __future__ import annotations

import ctypes
import functools

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
    "cull": 0,
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
# both packages choose the same kernels for a scene.
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
    over hitting lanes of max(near, 0) (BIG where none).  Chunked over K so
    nothing of size (K, B0, 128) is materialized."""
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
            torch.where(hit, torch.clamp_min(near, 0.0), BIG).amin(dim=2)
        )
    return torch.cat(hits).T.contiguous(), torch.cat(entries).T.contiguous()


def _order_hits(hits, entry, Le):
    """(B0, K) hit mask + entry distances -> near-ascending (meta, ids,
    nears, cutoff) lists of width Le (``cluster_pallas.py:178``).

    A stable sort of the entries (misses keyed BIG) orders each row's hit
    boxes near to far, ties by box id.  Rows with more than Le hits keep the
    Le nearest (trip = Le, overflow = 1) and a cutoff = the entry of the
    first box left out; other rows carry cutoff = +inf."""
    B0, K = hits.shape
    count = hits.sum(dim=1).to(torch.int32)
    key = torch.where(hits, entry, BIG)
    skey, sids = torch.sort(key, dim=1, stable=True)
    overflow = count > Le
    if K > Le:
        excl_entry = skey[:, Le]
    else:
        excl_entry = torch.full((B0,), BIG, dtype=torch.float32, device=hits.device)
    ids = sids[:, :Le].to(torch.int32).contiguous()
    trip = torch.where(overflow, Le, count)
    meta = torch.stack([trip, overflow.to(torch.int32)], dim=1)
    cutoff = torch.where(overflow, excl_entry, float("inf"))
    return meta, ids, skey[:, :Le].contiguous(), cutoff[:, None].contiguous()


def cull_plain(o3, d3, bmin, bmax, Le, tmax=None):
    """Plain torch K3: same inputs and outputs as :func:`cull`."""
    hits, entry = _rowhit_scan(o3, _safe_inv(d3), bmin, bmax, tmax)
    return _order_hits(hits, entry, Le)


def cull(o3, d3, bmin, bmax, Le, tmax=None):
    """K3: per-row cluster cull (``cluster_pallas.py:310``).

    o3, d3: (3, B0, 128) f32; bmin, bmax: (K, 3) f32 boxes; tmax: None or
    (B0, 128) f32 (then a box counts only where near <= tmax).  Returns
    (meta, ids, nears, cutoff) as in :func:`_order_hits`.  The lists only
    steer the visits, so the inputs are taken detached."""
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
    if not 1 <= Le <= K:
        raise ValueError(f"list width Le={Le} must lie in [1, K={K}]")
    if device.type == "cpu":
        return cull_plain(o3, d3, bmin, bmax, Le, tmax)
    from chiaroscuro_tpu_torch.ops import cull_triton

    hits, entry = cull_triton.rowhit(o3, _safe_inv(d3), bmin, bmax, tmax)
    LAUNCHES["cull"] += 1
    return _order_hits(hits, entry, Le)


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
    dev = o3.device
    best_t = torch.full((B0, LANE), BIG, dtype=torch.float32, device=dev)
    best_id = torch.full((B0, LANE), NO_ID, dtype=torch.int32, device=dev)
    best_u = torch.zeros((B0, LANE), dtype=torch.float32, device=dev)
    best_v = torch.zeros((B0, LANE), dtype=torch.float32, device=dev)
    for b in range(B0):
        o = tuple(o3[a, b][None] for a in range(3))          # (1, 128)
        d = tuple(d3[a, b][None] for a in range(3))
        bt, bi, bu, bv = best_t[b], best_id[b], best_u[b], best_v[b]
        for v0, e1, e2, oid in _tri_chunks(packed, _row_clusters(meta, ids, b, K)):
            ok, t, u, v = _mt_core(o, d, v0, e1, e2)         # (C, 128)
            valid = ok & (t < BIG)
            tm = torch.where(valid, t, BIG)
            tmin = tm.amin(dim=0)
            at_min = valid & (tm == tmin)
            idsel = torch.where(at_min, oid[:, None], NO_ID).amin(dim=0)
            # One-hot per lane (ids are unique); the winner's own t, u, v.
            sel = at_min & (oid[:, None] == idsel)
            pos = sel.to(torch.int8).argmax(dim=0, keepdim=True)
            ct = t.gather(0, pos)[0]
            better = sel.any(dim=0) & (
                (ct < bt) | ((ct == bt) & (idsel < bi))
            )
            bt = torch.where(better, ct, bt)
            bi = torch.where(better, idsel, bi)
            bu = torch.where(better, u.gather(0, pos)[0], bu)
            bv = torch.where(better, v.gather(0, pos)[0], bv)
        best_t[b], best_id[b], best_u[b], best_v[b] = bt, bi, bu, bv
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


# ---------------------------------------------------------------------------
# K4-K7: build, bind and launch.
# ---------------------------------------------------------------------------


@functools.cache
def build() -> tuple:
    """Build and load ``csrc/intersect_cluster.cu`` (``ops/cuda_build.py``);
    returns ``(lib, info)`` as :func:`~chiaroscuro_tpu_torch.ops.
    intersect_cuda.build` does.  A failed build raises."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    launches = {}
    for route in ("cluster", "resident"):
        launches[f"closest_{route}_launch"] = [vp] * 8 + [ci] * 4 + [vp] * 7
        launches[f"any_{route}_launch"] = [vp] * 9 + [ci] * 4 + [vp] * 3
    return bind("intersect_cluster", launches)


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


def _visits_out(visits, B0, device):
    """The optional (B0,) int32 per-row visit-count output; kernel only."""
    if visits is None:
        return None
    if device.type == "cpu":
        raise ValueError("visit counts are written by the kernels only")
    _check("visits", visits, (B0,), torch.int32, device)
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
    visits_ptr = _visits_out(visits, B0, device)
    if device.type == "cpu":
        return closest_cluster_plain(meta, ids, nears, cutoff, o3, d3, packed, attrs)
    if packed.data_ptr() % 16 or attrs.data_ptr() % 16:
        raise ValueError("packed and attrs must be 16-byte aligned")
    lib, _ = build()
    launch = getattr(lib, kernel + "_launch")
    K, _, M = packed.shape
    t = torch.empty((B0, LANE), dtype=torch.float32, device=device)
    tid = torch.empty((B0, LANE), dtype=torch.int32, device=device)
    u = torch.empty((B0, LANE), dtype=torch.float32, device=device)
    v = torch.empty((B0, LANE), dtype=torch.float32, device=device)
    am = torch.empty((ATTR_K, B0, LANE), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(
            meta.data_ptr(), ids.data_ptr(), nears.data_ptr(),
            cutoff.data_ptr(), o3.data_ptr(), d3.data_ptr(), packed.data_ptr(),
            attrs.data_ptr(), B0, Le, K, M, t.data_ptr(), tid.data_ptr(),
            u.data_ptr(), v.data_ptr(), am.data_ptr(), visits_ptr, stream,
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
    visits_ptr = _visits_out(visits, B0, device)
    if device.type == "cpu":
        return any_cluster_plain(meta, ids, nears, cutoff, o3, d3, tmax, excl, packed)
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned")
    lib, _ = build()
    launch = getattr(lib, kernel + "_launch")
    K, _, M = packed.shape
    occ = torch.empty((B0, LANE), dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(
            meta.data_ptr(), ids.data_ptr(), nears.data_ptr(),
            cutoff.data_ptr(), o3.data_ptr(), d3.data_ptr(), tmax.data_ptr(),
            excl.data_ptr(), packed.data_ptr(), B0, Le, K, M, occ.data_ptr(),
            visits_ptr, stream,
        )
    check_launch(lib, err, kernel)
    LAUNCHES[kernel] += 1
    return occ


def closest_resident(meta, ids, nears, cutoff, o3, d3, packed, attrs,
                     visits=None):
    """K4: closest hit of each planar ray over the row's listed clusters,
    each visited block read straight from global memory (L2).

    meta/ids/nears/cutoff: the cull's lists (:func:`cull`); o3, d3:
    (3, B0, 128) f32; packed: (K, 10, M) f32 (:func:`derive_buffers`);
    attrs: (T, ATTR_K) f32 original-order table; visits: None or a (B0,)
    int32 tensor that receives each row's cluster visit count (kernel
    only).  Returns (t, id, u, v, attrs_out) as K1 does; a miss keeps
    t = BIG, id 0.  Takes no gradient: see :func:`closest_cluster_diff`."""
    return _closest_visit("closest_resident", meta, ids, nears, cutoff, o3,
                          d3, packed, attrs, visits)


def closest_cluster(meta, ids, nears, cutoff, o3, d3, packed, attrs,
                    visits=None):
    """K6: :func:`closest_resident`'s function with each visited block
    staged through shared memory (``cp.async`` double buffer)."""
    return _closest_visit("closest_cluster", meta, ids, nears, cutoff, o3,
                          d3, packed, attrs, visits)


def any_resident(meta, ids, nears, cutoff, o3, d3, tmax, excl, packed,
                 visits=None):
    """K5: occlusion of each planar ray by a triangle of the row's listed
    clusters with id != excl at t < tmax, blocks read straight from global
    memory.  tmax: (B0, 128) f32; excl: (B0, 128) int32; visits as in
    :func:`closest_resident`.  Returns (B0, 128) bool; the inputs are taken
    detached."""
    return _any_visit("any_resident", meta, ids, nears, cutoff, o3, d3,
                      tmax, excl, packed, visits)


def any_cluster(meta, ids, nears, cutoff, o3, d3, tmax, excl, packed,
                visits=None):
    """K7: :func:`any_resident`'s function with each visited block staged
    through shared memory."""
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

    return closest_hit(fwd, o3, d3, tri_orig, attrs)


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
):
    """Cluster-culled intersector pair for large scenes
    (``cluster_pallas.py:991``), speaking the same interface as
    :func:`~chiaroscuro_tpu_torch.ops.intersect_cuda.make_dense_intersectors`
    (without ``live`` hints: parked rows cull to trip 0).

    The meshlet decomposition is built on the host from the scene's
    geometry unless ``clusters`` is given (a prebuilt ``ClusterArrays``,
    e.g. to rebuild the pair on a parameter-substituted scene without
    re-clustering, or the JAX package's ``build_clusters`` output read out
    as numpy).  ``Lmax`` is the list width (default 1536).  ``stream=None``
    applies the JAX package's rule (:func:`streams_by_budget`): the
    resident K4/K5 while the packed matrix is within 72 MiB, else the
    streaming K6/K7; ``stream=True``/``False`` forces a route on any scene.

    The closest query is differentiable with respect to the rays and the
    scene's fields (:func:`closest_cluster_diff`); occlusion is not.  The
    pair carries ``route`` (``"resident"`` or ``"stream"``) and
    ``prefers_compaction`` / ``prefers_ray_sort`` (K >= 1024), which the
    renderer and integrator read."""
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

    def closest_planar(o3, d3) -> ClosestHit:
        o3, d3 = o3.contiguous(), d3.contiguous()
        lists = cull(o3, d3, bmin, bmax, Le)
        t, tid, u, v, am = closest_cluster_diff(
            lists, o3, d3, tri_orig, attrs, packed, route
        )
        return ClosestHit(t < BIG, t, tid, u, v, unpack_attrs_planar(am))

    def any_planar(o3, d3, tmax, excl):
        o3, d3 = o3.detach().contiguous(), d3.detach().contiguous()
        tmax = tmax.detach().contiguous()
        lists = cull(o3, d3, bmin, bmax, Le, tmax=tmax)
        return _any_visit(
            ROUTES[route][1], *lists, o3, d3, tmax,
            excl.to(torch.int32).contiguous(), packed, None,
        )

    closest_fn, any_fn = row_major_pair(closest_planar, any_planar)
    closest_fn.route = any_fn.route = route
    closest_fn.prefers_compaction = K >= COMPACT_MIN_K
    closest_fn.prefers_ray_sort = K >= COMPACT_MIN_K
    return closest_fn, any_fn
