"""Dense ray-triangle intersection: CUDA kernels K1/K2, their plain torch
versions, and the intersector pair the integrator calls.

- K1 ``closest_dense`` replaces
  ``chiaroscuro_tpu/ops/intersect_pallas.py::_closest_kernel``: the closest
  hit of each ray over every triangle (lowest id wins a tie), with the
  winner's t, id, barycentrics and 32-float shading-attribute row.
- K2 ``any_dense`` replaces ``::_any_kernel``: occluded iff some triangle
  with id != excl hits at t < tmax.

The kernels live in ``csrc/intersect_dense.cu`` (its header says what bounds
them on an H100 and how the design answers it).  They read the triangles
from :func:`pad_table`'s (T, 12) copy of the (T, 9) rows, which
:func:`make_dense_intersectors` makes once per intersector pair; each block
keeps up to 4,096 of them, the dense path's ceiling, in shared memory at
once, and sweeps a larger table in chunks.  They are built with
``nvcc`` for ``sm_90a`` at first use into ``chiaroscuro_tpu_torch/_build/``
and bound with ``ctypes``.  Each wrapper takes the plain torch version only
for CPU tensors; for CUDA tensors it launches its kernel or raises — there
is no fallback.  ``LAUNCHES`` counts kernel launches, so a run can show that
its main path went through the kernels.

Rows whose ``live`` flag is 0 get the sentinels (t = BIG, id = 0,
u = v = 0, attributes 0; occluded = False) in the kernel and in its plain
version alike, so the two agree on every row.  (The TPU kernels skip only
8-row tiles with no live row; the integrator consumes no dead row either
way.)

Gradients (``intersect_pallas.py:430-504``, ``_closest_diff`` and its VJP):
``closest_dense`` is differentiable with respect to the rays, the (T, 9)
triangle rows and the (T, 32) attribute table through :func:`closest_hit`,
a ``torch.autograd.Function`` whose forward is the kernel and whose backward
recomputes the winner's t, u, v and attribute row with torch ops.  The JAX
package has no backward kernel either; its TPU-only one-hot backward fetch
(``_bwd_fetch``, an MXU workaround for slow gathers) is a plain gather here.
Occlusion is a discrete decision: ``any_dense`` takes detached inputs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from chiaroscuro_tpu_torch.geometry.intersect import ClosestHit
from chiaroscuro_tpu_torch.ops.cuda_build import bind, check_launch

FLT_EPS = float(np.finfo(np.float32).eps)
BIG = 3.0e38
LANE = 128

# Lanes that vote together in the kernels' warp-uniform reject: one warp,
# 32 consecutive lanes of a row (csrc/intersect_dense.cu).
REJECT_LANES = 32

# Kernel launch counts, by kernel.  Incremented only where a wrapper
# launches its kernel; the plain versions never count.
LAUNCHES = {"closest": 0, "any": 0}

# Shading-attribute row layout (the JAX package's ATTR_LAYOUT).
ATTR_LAYOUT = {
    "v0": slice(0, 3),
    "e1": slice(3, 6),
    "e2": slice(6, 9),
    "normal": slice(9, 12),
    "kd": slice(12, 15),
    "ke": slice(15, 18),
    "uv0": slice(18, 20),
    "uv1": slice(20, 22),
    "uv2": slice(22, 24),
    "btype": slice(24, 25),
    "texid": slice(25, 26),
    "ks": slice(26, 29),
    "ns": slice(29, 30),
    "texid_ks": slice(30, 31),
}
ATTR_K = 32

_INT_ATTRS = ("btype", "texid", "texid_ks")

# Plain versions stream triangles in chunks of about this many
# (triangle, ray) pairs, so their memory is O(rays * chunk).
_PLAIN_PAIRS = 1 << 22


def _prep_tris(v0, v1, v2):
    """(T, 9) rows [v0x v0y v0z e1x e1y e1z e2x e2y e2z]."""
    return torch.cat([v0, v1 - v0, v2 - v0], dim=1).contiguous()


def pad_table(tri_rows):
    """The kernels' copy of the (T, 9) triangle rows: (T, 12) f32
    ``v0|0|e1|0|e2|0``, 48 bytes a triangle, so that a kernel reads one as
    three 16-byte loads.  Detached: gradients flow through ``tri_rows``."""
    T = tri_rows.shape[0]
    table = tri_rows.new_zeros((T, 3, 4))
    table[:, :, :3] = tri_rows.detach().reshape(T, 3, 3)
    return table.reshape(T, 12)


def _prep_attrs(scene):
    """(T, ATTR_K) f32 shading-attribute table, one row per triangle.
    Int columns (btype/texid/texid_ks) ride as exact small floats."""
    cols = torch.cat(
        [
            scene.tri_v0,                                   # v0
            scene.tri_v1 - scene.tri_v0,                    # e1
            scene.tri_v2 - scene.tri_v0,                    # e2
            scene.normal,
            scene.kd,
            scene.ke,
            scene.uv0,
            scene.uv1,
            scene.uv2,
            scene.brdf_type[:, None].float(),
            scene.tex_id[:, None].float(),
            scene.ks,
            scene.shininess[:, None],
            scene.tex_id_ks[:, None].float(),
        ],
        dim=1,
    )                                                       # (T, 31)
    pad = cols.new_zeros((cols.shape[0], ATTR_K - cols.shape[1]))
    return torch.cat([cols, pad], dim=1).contiguous()


def unpack_attrs_planar(mat):
    """(ATTR_K, B0, 128) kernel output -> dict of planar per-field tensors:
    vec3 as (3, B0, 128), uv pairs as (2, B0, 128), scalars as (B0, 128)."""
    out = {}
    for name, sl in ATTR_LAYOUT.items():
        col = mat[sl]
        if name in _INT_ATTRS:
            out[name] = torch.round(col[0]).to(torch.int32)
        elif name == "ns":
            out[name] = col[0]
        else:
            out[name] = col
    return out


def _mt_front(o, d, v0, e1, e2):
    """The test up to u (CUDA ``mt_front``): p = cross(d, e2), the parallel
    test and f, s = o - v0 and u.  Returns (nonpar, f, s, u)."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2

    # p = cross(d, e2)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    a = e1x * px + e1y * py + e1z * pz
    nonpar = a.abs() >= FLT_EPS
    f = 1.0 / torch.where(nonpar, a, 1.0)

    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * px + sy * py + sz * pz)
    return nonpar, f, (sx, sy, sz), u


def _mt_core(o, d, v0, e1, e2):
    """Moller-Trumbore over broadcastable components, in the operand order
    of the JAX ``_mt_core`` and of the CUDA ``mt_test``: o, d are tuples of
    (1, R) ray rows, v0/e1/e2 tuples of (C, 1) triangle columns.  Returns
    (ok, t, u, v), each (C, R)."""
    dx, dy, dz = d
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    nonpar, f, (sx, sy, sz), u = _mt_front(o, d, v0, e1, e2)
    # q = cross(s, e1)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)

    ok = (
        nonpar
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= 0.0)
    )
    return ok, t, u, v


def _ray_rows(x3):
    """(3, B0, 128) -> tuple of three (1, R) rows."""
    return tuple(x3[a].reshape(1, -1) for a in range(3))


def _tri_chunks(tri_rows, R):
    """Yield (base, v0, e1, e2) column tuples of (C, 1) triangle chunks."""
    T = tri_rows.shape[0]
    chunk = max(1, min(T, _PLAIN_PAIRS // max(R, 1)))
    for base in range(0, T, chunk):
        tri = tri_rows[base:base + chunk]
        cols = tuple(tri[:, c:c + 1] for c in range(9))
        yield base, cols[0:3], cols[3:6], cols[6:9]


def closest_dense_plain(live, o3, d3, tri_rows, attrs):
    """Plain torch K1: same inputs and outputs as :func:`closest_dense`."""
    B0 = o3.shape[1]
    R = B0 * LANE
    dev = o3.device
    o, d = _ray_rows(o3), _ray_rows(d3)
    best_t = torch.full((R,), BIG, dtype=torch.float32, device=dev)
    best_id = torch.zeros((R,), dtype=torch.int32, device=dev)
    best_u = torch.zeros((R,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R,), dtype=torch.float32, device=dev)
    for base, v0, e1, e2 in _tri_chunks(tri_rows, R):
        ok, t, u, v = _mt_core(o, d, v0, e1, e2)
        C = t.shape[0]
        t = torch.where(ok, t, BIG)
        # First minimum within the chunk; the strict < below keeps earlier
        # chunks on ties between chunks: the lowest id wins.
        tmin = t.amin(dim=0, keepdim=True)
        rows = torch.arange(C, device=dev)[:, None]
        idx = torch.where(t == tmin, rows, C).amin(dim=0, keepdim=True)
        ct = t.gather(0, idx)[0]
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_id = torch.where(better, (base + idx[0]).to(torch.int32), best_id)
        best_u = torch.where(better, u.gather(0, idx)[0], best_u)
        best_v = torch.where(better, v.gather(0, idx)[0], best_v)
    lane_live = (live != 0).repeat_interleave(LANE)
    hit = lane_live & (best_t < BIG)
    best_t = torch.where(lane_live, best_t, BIG)
    best_id = torch.where(hit, best_id, 0)
    best_u = torch.where(hit, best_u, 0.0)
    best_v = torch.where(hit, best_v, 0.0)
    if attrs.shape[0]:
        am = torch.where(hit[:, None], attrs[best_id.long()], 0.0)   # (R, ATTR_K)
    else:                       # no triangle: nothing hits, nothing to gather
        am = attrs.new_zeros((R, ATTR_K))
    shape = (B0, LANE)
    return (
        best_t.reshape(shape),
        best_id.reshape(shape),
        best_u.reshape(shape),
        best_v.reshape(shape),
        am.T.reshape(ATTR_K, B0, LANE).contiguous(),
    )


def any_dense_plain(live, o3, d3, tmax, excl, tri_rows):
    """Plain torch K2: same inputs and outputs as :func:`any_dense`."""
    first = first_blockers(live, o3, d3, tmax, excl, tri_rows)
    return (first < tri_rows.shape[0]).reshape(o3.shape[1], LANE)


def first_blockers(live, o3, d3, tmax, excl, tri_rows):
    """(R,) int64: each lane's first blocker in id order (a hit at t < tmax
    with id != excl), T where none or where the row is dead; the lane's
    last test in K2, which stops there."""
    B0 = o3.shape[1]
    R = B0 * LANE
    T = tri_rows.shape[0]
    dev = o3.device
    o, d = _ray_rows(o3), _ray_rows(d3)
    tm, ex = tmax.reshape(1, R), excl.reshape(1, R)
    first = torch.full((R,), T, dtype=torch.int64, device=dev)
    for base, v0, e1, e2 in _tri_chunks(tri_rows, R):
        ok, t, _, _ = _mt_core(o, d, v0, e1, e2)
        ids = torch.arange(base, base + t.shape[0], device=dev)[:, None]
        blk = ok & (t < tm) & (ids != ex)
        first = torch.minimum(first, torch.where(blk, ids, T).amin(dim=0))
    lane_live = (_live_rows(live, B0, dev) != 0).repeat_interleave(LANE)
    return torch.where(lane_live, first, T)


def reject_counts(live, o3, d3, tri_rows, tmax=None, excl=None, per_warp=False):
    """The (lane, triangle) tests that the kernels' warp-uniform reject
    leaves, over the lanes of live rows: ``(full, front)``, the tests run
    to the end and those stopped after u because no lane of their group of
    REJECT_LANES (one warp) could still accept there (nonpar and
    0 <= u <= 1).  With ``tmax``/``excl`` (K2) a lane tests up to and
    including its first blocker (:func:`first_blockers`) and votes on those
    tests only; with ``per_warp`` every lane of a group tests up to the
    group's last first blocker, as a warp whose lanes all run until the
    last is occluded.  What the kernels' bound counts: a full test is
    MT_OPS operations, a stopped one the front's."""
    B0 = o3.shape[1]
    R = B0 * LANE
    dev = o3.device
    o, d = _ray_rows(o3), _ray_rows(d3)
    lane_live = (_live_rows(live, B0, dev) != 0).repeat_interleave(LANE)
    first = last = None
    if tmax is not None:
        first = last = first_blockers(live, o3, d3, tmax, excl, tri_rows)
        if per_warp:
            last = first.reshape(-1, REJECT_LANES).amax(dim=1)
            last = last.repeat_interleave(REJECT_LANES)
    full = torch.zeros((), dtype=torch.int64, device=dev)
    tested_all = torch.zeros((), dtype=torch.int64, device=dev)
    for base, v0, e1, e2 in _tri_chunks(tri_rows, R):
        nonpar, _, _, u = _mt_front(o, d, v0, e1, e2)
        C = u.shape[0]
        tested = voting = lane_live.expand(C, R)
        if first is not None:
            ids = torch.arange(base, base + C, device=dev)[:, None]
            tested = tested & (ids <= last)
            voting = voting & (ids <= first)
        cand = voting & nonpar & (u >= 0.0) & (u <= 1.0)
        groups = (C, R // REJECT_LANES, REJECT_LANES)
        vote = cand.reshape(groups).any(dim=-1, keepdim=True)
        tested = tested.reshape(groups)
        full += (tested & vote).sum()
        tested_all += tested.sum()
    return int(full), int(tested_all - full)


# ---------------------------------------------------------------------------
# Build and bind the CUDA library.
# ---------------------------------------------------------------------------

@functools.cache
def build() -> tuple:
    """Build (once per source and flag set) and load the kernel library
    (``ops/cuda_build.py``).  Returns ``(lib, info)`` where ``info`` holds
    the library path, the build seconds (0.0 when an earlier build was
    reused) and nvcc's ``-Xptxas -v`` report.  A failed build raises with
    nvcc's output."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return bind("intersect_dense", {
        "closest_dense_launch": [vp] * 5 + [ci, ci] + [vp] * 6,
        "any_dense_launch": [vp] * 6 + [ci, ci] + [vp] * 2,
    })


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _live_rows(live, B0, device):
    """(B0,) int32 row flags from None (all live) or a (B0,)/(B0, 1) hint."""
    if live is None:
        return torch.ones((B0,), dtype=torch.int32, device=device)
    if live.numel() != B0:
        raise ValueError(f"live has {live.numel()} entries, expected {B0}")
    return live.reshape(B0).to(device=device, dtype=torch.int32).contiguous()


def _launch_device(*tensors) -> torch.device:
    """The device the wrapper runs on."""
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def closest_dense(live, o3, d3, tri_rows, attrs, table=None):
    """K1: closest hit of each planar ray over all triangles.

    live: None or (B0,)/(B0, 1) row flags; o3, d3: (3, B0, 128) f32;
    tri_rows: (T, 9) f32 (:func:`_prep_tris`); attrs: (T, ATTR_K) f32
    (:func:`_prep_attrs`); table: the kernel's (T, 12) copy of tri_rows
    (:func:`pad_table`), made here when None.  Returns (t, id, u, v,
    attrs_out): (B0, 128) f32/int32/f32/f32 and (ATTR_K, B0, 128) f32; a
    miss keeps t = BIG.  Differentiable with respect to o3, d3, tri_rows
    and attrs (:func:`closest_hit`)."""
    return closest_hit(functools.partial(_closest_dense_launch, live, table=table),
                       o3, d3, tri_rows, attrs)


def _table(table, tri_rows, device):
    """The kernel's (T, 12) table: ``table`` checked, or made from
    ``tri_rows``."""
    if table is None:
        table = pad_table(tri_rows)
    _check("table", table, (tri_rows.shape[0], 12), torch.float32, device)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    return table


def _closest_dense_launch(live, o3, d3, tri_rows, attrs, table=None):
    """K1 on detached inputs: the kernel, or its plain version on the
    CPU."""
    device = _launch_device(o3, d3, tri_rows, attrs)
    B0 = o3.shape[1]
    T = tri_rows.shape[0]
    live = _live_rows(live, B0, device)
    _check("o3", o3, (3, B0, LANE), torch.float32, device)
    _check("d3", d3, (3, B0, LANE), torch.float32, device)
    _check("tri_rows", tri_rows, (T, 9), torch.float32, device)
    _check("attrs", attrs, (T, ATTR_K), torch.float32, device)
    if device.type == "cpu":
        return closest_dense_plain(live, o3, d3, tri_rows, attrs)
    if attrs.data_ptr() % 16:
        raise ValueError("attrs must be 16-byte aligned")
    table = _table(table, tri_rows, device)
    lib, _ = build()
    t = torch.empty((B0, LANE), dtype=torch.float32, device=device)
    tid = torch.empty((B0, LANE), dtype=torch.int32, device=device)
    u = torch.empty((B0, LANE), dtype=torch.float32, device=device)
    v = torch.empty((B0, LANE), dtype=torch.float32, device=device)
    am = torch.empty((ATTR_K, B0, LANE), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.closest_dense_launch(
            live.data_ptr(), o3.data_ptr(), d3.data_ptr(), table.data_ptr(),
            attrs.data_ptr(), B0, T, t.data_ptr(), tid.data_ptr(), u.data_ptr(),
            v.data_ptr(), am.data_ptr(), stream,
        )
    check_launch(lib, err, "closest_dense")
    LAUNCHES["closest"] += 1
    return t, tid, u, v, am


def any_dense(live, o3, d3, tmax, excl, tri_rows, table=None):
    """K2: occlusion of each planar ray by any triangle with id != excl at
    t < tmax.  tmax: (B0, 128) f32; excl: (B0, 128) int32; table as for
    :func:`closest_dense`.  Returns (B0, 128) bool.  Occlusion is a
    discrete decision: the inputs are taken detached
    (``intersect_pallas.py:586-603``)."""
    o3, d3, tmax, tri_rows = (x.detach() for x in (o3, d3, tmax, tri_rows))
    device = _launch_device(o3, d3, tmax, tri_rows)
    B0 = o3.shape[1]
    T = tri_rows.shape[0]
    live = _live_rows(live, B0, device)
    _check("o3", o3, (3, B0, LANE), torch.float32, device)
    _check("d3", d3, (3, B0, LANE), torch.float32, device)
    _check("tmax", tmax, (B0, LANE), torch.float32, device)
    _check("excl", excl, (B0, LANE), torch.int32, device)
    _check("tri_rows", tri_rows, (T, 9), torch.float32, device)
    if device.type == "cpu":
        return any_dense_plain(live, o3, d3, tmax, excl, tri_rows)
    table = _table(table, tri_rows, device)
    lib, _ = build()
    occ = torch.empty((B0, LANE), dtype=torch.bool, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.any_dense_launch(
            live.data_ptr(), o3.data_ptr(), d3.data_ptr(), tmax.data_ptr(),
            excl.data_ptr(), table.data_ptr(), B0, T, occ.data_ptr(), stream,
        )
    check_launch(lib, err, "any_dense")
    LAUNCHES["any"] += 1
    return occ


# ---------------------------------------------------------------------------
# The closest-hit gradient.
# ---------------------------------------------------------------------------


def _recompute_hit(o3, d3, tri_rows, attrs, tid):
    """t, u, v and the attribute column of the triangle ``tid`` for each
    planar ray, in ``_mt_core``'s operand order: what the forward computed
    for a hit, as differentiable torch ops (``intersect_pallas.py:485-495``).
    tri_rows (T, 9) and attrs (T, ATTR_K) are in original triangle order."""
    idx = tid.long()
    tri = tri_rows[idx].permute(2, 0, 1)                    # (9, B0, 128)
    _, t, u, v = _mt_core(
        (o3[0], o3[1], o3[2]), (d3[0], d3[1], d3[2]),
        (tri[0], tri[1], tri[2]), (tri[3], tri[4], tri[5]),
        (tri[6], tri[7], tri[8]),
    )
    return t, u, v, attrs[idx].permute(2, 0, 1)             # (ATTR_K, B0, 128)


class _ClosestHit(torch.autograd.Function):
    """A closest-hit query whose forward is a kernel (or its plain
    version) and whose backward is the recompute of ``_closest_diff_bwd``
    (``intersect_pallas.py:480-501``) and of the cluster ``_closest_bwd``
    (``cluster_pallas.py:1174-1195``): the hit triangle is fixed (ids are
    detached), and the cotangents of missed rays are masked to zero."""

    @staticmethod
    def forward(ctx, fwd, o3, d3, tri_rows, attrs):
        out = fwd(o3.detach(), d3.detach(), tri_rows.detach(), attrs.detach())
        t, tid = out[0], out[1]
        ctx.save_for_backward(o3, d3, tri_rows, attrs, tid, t < BIG)
        ctx.mark_non_differentiable(tid)
        return out

    @staticmethod
    def backward(ctx, ct_t, _ct_tid, ct_u, ct_v, ct_am):
        o3, d3, tri_rows, attrs, tid, hit = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        h = hit.to(torch.float32)
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n)
                  for x, n in zip((o3, d3, tri_rows, attrs), need)]
            outs = _recompute_hit(*xs, tid)
            cts = (ct_t * h, ct_u * h, ct_v * h, ct_am * h[None])
            pairs = [(y, c) for y, c in zip(outs, cts) if y.requires_grad]
            wanted = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(
                [y for y, _ in pairs], wanted, [c for _, c in pairs],
                allow_unused=True,
            ) if pairs else [None] * len(wanted))
        return (None, *(next(grads) if n else None for n in need))


def closest_hit(fwd, o3, d3, tri_rows, attrs):
    """``fwd(o3, d3, tri_rows, attrs) -> (t, id, u, v, attrs_out)``, made
    differentiable with respect to o3, d3, tri_rows and attrs where any of
    them requires grad.  ``fwd`` runs on detached inputs (a kernel launch
    or its plain version) and must take the original-order (T, 9) rows and
    (T, ATTR_K) table whose rows its ids index."""
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (o3, d3, tri_rows, attrs)
    ):
        return _ClosestHit.apply(fwd, o3, d3, tri_rows, attrs)
    return fwd(o3, d3, tri_rows, attrs)


def _rows_to_planar(rows):
    """(R, 3) -> ((3, B0, 128), R), padded to a 128 multiple with replicas
    of the first row."""
    R = rows.shape[0]
    pad = (-R) % LANE
    if pad:
        rows = torch.cat([rows, rows[:1].expand(pad, 3)])
    return rows.T.reshape(3, -1, LANE).contiguous(), R


def _pad_lanes(x, R):
    pad = (-R) % LANE
    if pad:
        x = torch.cat([x, x[:1].expand(pad)])
    return x.reshape(-1, LANE).contiguous()


def row_major_pair(closest_planar, any_planar):
    """The ``(R, 3)`` oracle interface over planar intersectors:
    ``closest_fn(origins, dirs)`` / ``any_fn(origins, dirs, tmax, excl)``,
    each carrying its planar function as ``.planar_fn``."""

    def closest_fn(origins, dirs) -> ClosestHit:
        o3, R = _rows_to_planar(origins)
        d3, _ = _rows_to_planar(dirs)
        res = closest_planar(o3, d3)
        attrs_rows = {
            k: (pv.reshape(pv.shape[0], -1).T[:R] if pv.dim() == 3
                else pv.reshape(-1)[:R])
            for k, pv in res.attrs.items()
        }
        return ClosestHit(
            *(x.reshape(-1)[:R] for x in res[:5]), attrs_rows
        )

    def any_fn(origins, dirs, tmax, exclude_id):
        o3, R = _rows_to_planar(origins)
        d3, _ = _rows_to_planar(dirs)
        occ = any_planar(o3, d3, _pad_lanes(tmax, R), _pad_lanes(exclude_id, R))
        return occ.reshape(-1)[:R]

    closest_fn.planar_fn = closest_planar
    any_fn.planar_fn = any_planar
    return closest_fn, any_fn


def make_dense_intersectors(scene):
    """The dense intersector pair over the scene's triangles.

    ``closest_fn(origins, dirs)`` / ``any_fn(origins, dirs, tmax, excl)``
    speak the row-major ``(R, 3)`` oracle interface; each carries
    ``.planar_fn`` speaking the planar ``(3, B0, 128)`` layout, which the
    integrator calls with a ``live`` (B0, 1) row hint (``.accepts_live``).

    The triangle rows and the attribute table are derived from the scene's
    fields without detaching them, so a pair made from a scene whose fields
    require grad (``SceneTensors.replace``) carries gradients to them; the
    kernels' (T, 12) copy of the rows (:func:`pad_table`) is made once here,
    detached.
    """
    tri_rows = _prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    attrs = _prep_attrs(scene)
    table = pad_table(tri_rows)

    def closest_planar(o3, d3, live=None) -> ClosestHit:
        t, tid, u, v, am = closest_dense(
            live, o3.contiguous(), d3.contiguous(), tri_rows, attrs, table
        )
        return ClosestHit(t < BIG, t, tid, u, v, unpack_attrs_planar(am))

    def any_planar(o3, d3, tmax, excl, live=None):
        return any_dense(
            live, o3.contiguous(), d3.contiguous(), tmax.contiguous(),
            excl.to(torch.int32).contiguous(), tri_rows, table,
        )

    closest_fn, any_fn = row_major_pair(closest_planar, any_planar)
    closest_fn.accepts_live = True
    any_fn.accepts_live = True
    return closest_fn, any_fn
