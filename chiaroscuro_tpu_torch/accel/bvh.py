"""Flattened BVH: host-side SAH build + stackless threaded traversal.

The port of ``chiaroscuro_tpu/accel/bvh.py``, the structural analog of the
reference's kd-tree (``src/kdtree.cpp:110-344``):

- **Build on the host, once, at scene-load time.**  The binned-SAH builder
  (:func:`_build_host`, a numpy copy of the JAX package's) and its C++ twin
  ``csrc/bvh_builder.cpp`` (built with ``g++`` at first use into
  ``chiaroscuro_tpu_torch/_build/`` and loaded with ``ctypes``) give the same
  arrays; where the library cannot be built the numpy builder takes over
  with a printed warning, as in the JAX package.
- **Threaded ("skip-link") layout**: nodes in DFS order, each with a
  ``miss_link``.  A ray's whole traversal state is one node index: on a box
  hit at an internal node step to ``i + 1``, otherwise jump to
  ``miss_link[i]``; the sentinel -1 ends the walk.
- **Leaf triangles are re-ordered contiguously**, pre-gathered as
  ``tri_v0 / tri_e1 / tri_e2`` so a leaf is a (start, count) range.
- **Node boxes are padded** by ``accel/clusters.BOX_PAD`` after the build
  (the boxes the build computes are the JAX package's), so that a box holds every
  hit Moller-Trumbore reports inside it, rounding included: a box never
  rejects a hit that lies on its face, or a blocker just short of tmax.
- **The closest hit is the least (t, original id)** over every hit the test
  reports, whatever the walk order (the benchmark's reference, K1 and K4
  alike).  The JAX package keeps the first minimum in walk order over tight
  boxes (ROADMAP section 3, deliberate deviations).

:func:`bvh_closest` / :func:`bvh_any` are the **plain versions** of the
walk: the JAX package's lock-step wavefront loop (``lax.while_loop``), with
the two changes above and the loop's condition read back to the host each
step.  On the card the walk is the kernels B1/B2 (``ops/bvh_cuda.py``, one
thread per ray), which :func:`make_bvh_intersectors` launches for CUDA
tensors.

Gradients: the walk's t, u and v come from the BVH's detached copies of the
vertices, so no geometry gradient can flow through a hit (in the JAX
package ``build_bvh`` fails on a traced vertex array).  Material gradients
(kd, ke, ks, shininess, tex_data) flow through the integrator's row path,
which gathers them by the hit id.  A scene whose vertices require grad
raises :class:`ValueError` here rather than return a partial vertex
gradient (the row path's ``tri_v0[tid]`` with u and v held constant).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from chiaroscuro_tpu_torch.accel.clusters import BOX_PAD
from chiaroscuro_tpu_torch.geometry.intersect import AnyFn, ClosestFn, ClosestHit
from chiaroscuro_tpu_torch.ops.intersect_cuda import _mt_core
from chiaroscuro_tpu_torch.scene.scene_arrays import SceneTensors

SENTINEL = -1
_NO_ID = torch.iinfo(torch.int32).max   # above every triangle id (ids stay under 2^24)


@dataclasses.dataclass
class BVHArrays:
    """Flattened threaded BVH on one device, packed as the kernels B1/B2
    read it (``csrc/bvh_traverse.cu``); the plain walk reads the same
    tensors through the views below."""

    nodes: torch.Tensor       # (N, 8) f32: bmin.xyz | miss_link bits | bmax.xyz | leaf_count bits
    #                           (boxes padded by BOX_PAD)
    leaf_start: torch.Tensor  # (N,) i32 start into tri_order, -1 for internal
    tri_order: torch.Tensor   # (T_padded,) i32 permutation of triangle ids
    # Pre-gathered, reordered triangle geometry (leaf-contiguous), 48 bytes
    # a triangle so that a kernel reads one as three 16-byte loads:
    tris: torch.Tensor        # (T_padded, 12) f32: v0 | 0 | e1 | 0 | e2 | 0
    n_nodes: int = 0
    leaf_size: int = 8
    builder: str = "numpy"        # "native" (csrc/bvh_builder.cpp) or "numpy"
    build_seconds: float = 0.0    # the host build, the native library's compile excluded

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    @property
    def bbox_min(self) -> torch.Tensor:   # (N, 3) f32
        return self.nodes[:, 0:3]

    @property
    def miss_link(self) -> torch.Tensor:  # (N,) i32 node to jump to when the box test fails
        return self.nodes[:, 3].view(torch.int32)

    @property
    def bbox_max(self) -> torch.Tensor:   # (N, 3) f32
        return self.nodes[:, 4:7]

    @property
    def leaf_count(self) -> torch.Tensor:  # (N,) i32 triangles in the leaf (0 for internal)
        return self.nodes[:, 7].view(torch.int32)

    @property
    def tri_v0(self) -> torch.Tensor:     # (T_padded, 3) f32
        return self.tris[:, 0:3]

    @property
    def tri_e1(self) -> torch.Tensor:     # (T_padded, 3) f32  v1 - v0
        return self.tris[:, 4:7]

    @property
    def tri_e2(self) -> torch.Tensor:     # (T_padded, 3) f32  v2 - v0
        return self.tris[:, 8:11]


# ---------------------------------------------------------------------------
# Host-side build (numpy)
# ---------------------------------------------------------------------------

N_BINS = 16


def _build_host(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int
) -> Tuple[np.ndarray, ...]:
    T = len(v0)
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tri_min + tri_max) * 0.5

    # Node arrays, grown as python lists of tuples then stacked.
    bbox_min, bbox_max = [], []
    leaf_start, leaf_count = [], []
    right_child = []  # index of second child, -1 for leaf (DFS: first = i+1)
    tri_order: list = []

    def surface(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def build(ids: np.ndarray) -> int:
        node = len(bbox_min)
        mn = tri_min[ids].min(axis=0)
        mx = tri_max[ids].max(axis=0)
        bbox_min.append(mn)
        bbox_max.append(mx)
        leaf_start.append(-1)
        leaf_count.append(0)
        right_child.append(-1)

        if len(ids) <= leaf_size:
            leaf_start[node] = len(tri_order)
            leaf_count[node] = len(ids)
            tri_order.extend(ids.tolist())
            return node

        # Binned SAH over the widest centroid axis.
        c = centroid[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        extent = cmax - cmin
        axis = int(extent.argmax())
        if extent[axis] <= 0.0:
            # All centroids coincide: split evenly to guarantee progress.
            half = len(ids) // 2
            left_ids, right_ids = ids[:half], ids[half:]
        else:
            scale = N_BINS * (1.0 - 1e-6) / extent[axis]
            bins = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
            # Bin bounds + counts.
            counts = np.bincount(bins, minlength=N_BINS)
            bmn = np.full((N_BINS, 3), np.inf)
            bmx = np.full((N_BINS, 3), -np.inf)
            for b in range(N_BINS):
                sel = bins == b
                if counts[b]:
                    bmn[b] = tri_min[ids[sel]].min(axis=0)
                    bmx[b] = tri_max[ids[sel]].max(axis=0)
            # Sweep: cost(split after bin k) = SA_L*N_L + SA_R*N_R.
            best_cost, best_k = np.inf, -1
            lmn, lmx = np.full(3, np.inf), np.full(3, -np.inf)
            lcounts = np.zeros(N_BINS)
            lsa = np.zeros(N_BINS)
            for k in range(N_BINS - 1):
                if counts[k]:
                    lmn = np.minimum(lmn, bmn[k])
                    lmx = np.maximum(lmx, bmx[k])
                lcounts[k] = counts[: k + 1].sum()
                lsa[k] = surface(lmn, lmx) if lcounts[k] else 0.0
            rmn, rmx = np.full(3, np.inf), np.full(3, -np.inf)
            for k in range(N_BINS - 2, -1, -1):
                if counts[k + 1]:
                    rmn = np.minimum(rmn, bmn[k + 1])
                    rmx = np.maximum(rmx, bmx[k + 1])
                rc = counts[k + 1 :].sum()
                if lcounts[k] == 0 or rc == 0:
                    continue
                cost = lsa[k] * lcounts[k] + surface(rmn, rmx) * rc
                if cost < best_cost:
                    best_cost, best_k = cost, k
            if best_k < 0:
                half = len(ids) // 2
                order = np.argsort(c[:, axis], kind="stable")
                left_ids, right_ids = ids[order[:half]], ids[order[half:]]
            else:
                sel = bins <= best_k
                left_ids, right_ids = ids[sel], ids[~sel]

        build(left_ids)  # first child at node+1 (DFS)
        right_child[node] = build(right_ids)
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(np.arange(T))
    finally:
        sys.setrecursionlimit(old_limit)

    n = len(bbox_min)
    right = np.asarray(right_child, np.int32)
    ls = np.asarray(leaf_start, np.int32)
    lc = np.asarray(leaf_count, np.int32)

    # miss links: traversal in DFS order; node i's subtree spans [i, end_i).
    # miss_link[i] = end of subtree (next node after it), SENTINEL at root.
    miss = np.full(n, SENTINEL, np.int32)

    stack = [(0, SENTINEL)]   # iterative DFS: no recursion limit on deep trees
    while stack:
        i, esc = stack.pop()
        miss[i] = esc
        if lc[i] == 0:  # internal: children are i+1 and right[i]
            stack.append((i + 1, right[i]))
            stack.append((right[i], esc))

    return (
        np.asarray(bbox_min, np.float32),
        np.asarray(bbox_max, np.float32),
        miss,
        ls,
        lc,
        np.asarray(tri_order, np.int32),
    )


@functools.cache
def _native_lib() -> Optional[ctypes.CDLL]:
    """The native builder (``csrc/bvh_builder.cpp``), built at first use;
    None, with a printed warning, where it cannot be built or loaded."""
    from chiaroscuro_tpu_torch.ops.cuda_build import build_host_library

    try:
        lib, _ = build_host_library("bvh_builder")
    except (RuntimeError, OSError) as e:
        print(f"WARNING: native BVH build failed ({e}); numpy fallback")
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build.argtypes = [
        f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p, i32p, i32p, i32p, i32p, i32p,
    ]
    return lib


def _build_host_native(v0, v1, v2, leaf_size):
    """The C++ builder via ctypes; same layout and split policy as
    :func:`_build_host`.  Returns None if the library is unavailable."""
    lib = _native_lib()
    if lib is None:
        return None

    T = len(v0)
    cap = 2 * max(T, 1)
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    miss = np.empty(cap, np.int32)
    ls = np.empty(cap, np.int32)
    lc = np.empty(cap, np.int32)
    order = np.empty(max(T, 1), np.int32)
    n_nodes = np.zeros(1, np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    c0 = np.ascontiguousarray(v0, np.float32)
    c1 = np.ascontiguousarray(v1, np.float32)
    c2 = np.ascontiguousarray(v2, np.float32)
    rc = lib.bvh_build(
        fp(c0), fp(c1), fp(c2), T, leaf_size,
        fp(bmin), fp(bmax), ip(miss), ip(ls), ip(lc), ip(order),
        ip(n_nodes),
    )
    if rc != 0:
        return None
    n = int(n_nodes[0])
    return bmin[:n], bmax[:n], miss[:n], ls[:n], lc[:n], order[:T]


def check_no_vertex_grad(scene: SceneTensors) -> None:
    """Raise where a vertex field requires grad: the BVH path has no
    geometry gradient (module docstring)."""
    if any(getattr(scene, f).requires_grad for f in ("tri_v0", "tri_v1", "tri_v2")):
        raise ValueError(
            "the BVH intersector has no gradient with respect to the vertices "
            "(tri_v0/tri_v1/tri_v2): its hits come from a detached copy of the "
            "geometry. Use intersector 'dense' or 'cluster' for geometry "
            "gradients; material gradients (kd, ke, ks, shininess, tex_data) "
            "flow through 'bvh'"
        )


def build_bvh(
    scene: SceneTensors, leaf_size: int = 8, native: bool = True
) -> BVHArrays:
    """The scene's BVH, built on the host and placed on the scene's
    device.  ``native`` tries the C++ builder first.  The node boxes are
    the build's, padded by ``BOX_PAD`` here (module docstring)."""
    check_no_vertex_grad(scene)
    v0, v1, v2 = (getattr(scene, f).cpu().numpy() for f in ("tri_v0", "tri_v1", "tri_v2"))
    if native:
        _native_lib()           # its first call compiles it: not part of the build time
    t0 = time.perf_counter()
    built = _build_host_native(v0, v1, v2, leaf_size) if native else None
    builder = "native"
    if built is None:
        built = _build_host(v0, v1, v2, leaf_size)
        builder = "numpy"
    seconds = time.perf_counter() - t0
    bmin, bmax, miss, ls, lc, order = built

    # Pad tri_order to a multiple of leaf_size with a degenerate slot so the
    # fixed-width leaf gather never reads OOB.
    pad = (-len(order)) % max(leaf_size, 1) + leaf_size
    order_p = np.concatenate([order, np.zeros(pad, np.int32)])

    ov0 = v0[order_p]
    ov1 = v1[order_p]
    ov2 = v2[order_p]
    # Zero out padding so padded lanes can never hit (a == 0 -> miss).
    ov0[len(order):] = 0
    ov1[len(order):] = 0
    ov2[len(order):] = 0

    nodes = np.zeros((len(bmin), 8), np.float32)
    pad = np.float32(BOX_PAD)
    nodes[:, 0:3], nodes[:, 4:7] = bmin - pad, bmax + pad
    nodes[:, 3], nodes[:, 7] = miss.view(np.float32), lc.view(np.float32)
    tris = np.zeros((len(order_p), 12), np.float32)
    tris[:, 0:3], tris[:, 4:7], tris[:, 8:11] = ov0, ov1 - ov0, ov2 - ov0

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(scene.device)

    return BVHArrays(
        nodes=put(nodes),
        leaf_start=put(ls),
        tri_order=put(order_p),
        tris=put(tris),
        n_nodes=len(bmin),
        leaf_size=leaf_size,
        builder=builder,
        build_seconds=seconds,
    )


# ---------------------------------------------------------------------------
# The plain walk (the JAX package's lax.while_loop over the ray wavefront)
# ---------------------------------------------------------------------------


def step_limit(bvh: BVHArrays, max_iters: int = 0) -> int:
    """The walk's step cap: ``max_iters``, or ``4 * n_nodes + 8``."""
    return max_iters if max_iters > 0 else 4 * bvh.n_nodes + 8


def _leaf_test(bvh: BVHArrays, origins, dirs, start, count):
    """Moller-Trumbore (``_mt_core``'s operand order) over each ray's
    ``leaf_size`` leaf slots: returns (slots, ok, t, u, v), each (R, L);
    ``ok`` (a valid slot that accepts) without the t limit."""
    L = bvh.leaf_size
    lanes = torch.arange(L, dtype=torch.int32, device=origins.device)[None, :]
    slots = start[:, None] + lanes                              # (R, L)
    valid_slot = lanes < count[:, None]
    slots = torch.where(valid_slot, slots, 0).long()

    def comps(x):
        return x[..., 0], x[..., 1], x[..., 2]

    ok, t, u, v = _mt_core(
        comps(origins[:, None, :]), comps(dirs[:, None, :]), comps(bvh.tri_v0[slots]),
        comps(bvh.tri_e1[slots]), comps(bvh.tri_e2[slots]),
    )
    return slots, valid_slot & ok, t, u, v


def _box_hit(origins, inv_dirs, bmin, bmax, tmax):
    """Slab test against per-ray gathered boxes; hit iff [t0, t1] overlaps
    [0, tmax] (kdtree.cpp:196-216 semantics with running-tmax pruning).
    ``minimum``/``maximum``/``amax``/``amin`` propagate NaN (an on-plane
    origin of an axis-parallel ray gives 0 * inf), and the box then misses,
    as in the JAX package."""
    t0 = (bmin - origins) * inv_dirs
    t1 = (bmax - origins) * inv_dirs
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return (far >= near) & (far >= 0.0) & (near < tmax)


def _mark_seen(seen, bvh, nodes, active, slots, n_tested):
    """Mark the nodes a step visits and the leaf slots it tests in
    ``seen`` = (node mask (N,), slot mask (T_padded,)), bool."""
    if seen is None:
        return
    lanes = torch.arange(bvh.leaf_size, device=slots.device)[None, :]
    seen[0][nodes[active]] = True
    seen[1][slots[lanes < n_tested[:, None]]] = True


def bvh_closest(bvh: BVHArrays, origins, dirs, max_iters: int = 0, counts: bool = False,
                seen=None):
    """Plain closest hit of (R, 3) ray rows: (hit, t, tid, u, v), t = inf
    on a miss; the least (t, original id) of the hits (a hit replaces the
    running best where its t is smaller, or equal with a smaller id; inside
    a leaf the least (t, id) of the slots that do).  With
    ``counts`` also each ray's (steps, leaf triangle tests), int32; with
    ``seen`` (:func:`_mark_seen`) the nodes and slots the walks touch:
    what B1's bound counts."""
    R = origins.shape[0]
    dev = origins.device
    inv = 1.0 / dirs

    t_best = torch.full((R,), float("inf"), device=dev)
    tid = torch.zeros((R,), dtype=torch.int32, device=dev)
    uu = torch.zeros((R,), device=dev)
    vv = torch.zeros((R,), device=dev)
    node = torch.zeros((R,), dtype=torch.int32, device=dev)
    steps = torch.zeros((R,), dtype=torch.int32, device=dev)
    tests = torch.zeros((R,), dtype=torch.int32, device=dev)
    rows = torch.arange(R, device=dev)

    limit = step_limit(bvh, max_iters)
    it = 0
    while it < limit and bool((node != SENTINEL).any()):
        active = node != SENTINEL
        ni = torch.where(active, node, 0).long()

        hit_box = _box_hit(origins, inv, bvh.bbox_min[ni], bvh.bbox_max[ni], t_best) & active

        count = bvh.leaf_count[ni]
        is_leaf = (count > 0) & hit_box
        leaf_count = torch.where(is_leaf, count, 0)

        slots, ok, t, u, v = _leaf_test(bvh, origins, dirs, bvh.leaf_start[ni], leaf_count)
        ids = bvh.tri_order[slots]
        tb = t_best[:, None]
        ok = ok & ((t < tb) | ((t == tb) & (ids < tid[:, None])))
        t = torch.where(ok, t, float("inf"))
        lt = t.amin(dim=1)
        best = torch.argmin(torch.where(ok & (t == lt[:, None]), ids, _NO_ID), dim=1)
        better = torch.isfinite(lt) & is_leaf
        t_best = torch.where(better, lt, t_best)
        tid = torch.where(better, ids[rows, best], tid)
        uu = torch.where(better, u[rows, best], uu)
        vv = torch.where(better, v[rows, best], vv)

        # Advance: internal box-hit -> i+1; leaf or miss -> miss_link.
        descend = hit_box & (count == 0)
        nxt = torch.where(descend, ni.int() + 1, bvh.miss_link[ni])
        node = torch.where(active, nxt, node)
        steps += active.int()
        tests += leaf_count
        _mark_seen(seen, bvh, ni, active, slots, leaf_count)
        it += 1

    hit = torch.isfinite(t_best)
    out = (hit, t_best, tid, uu, vv)
    return out + ((steps, tests),) if counts else out


def bvh_any(bvh: BVHArrays, origins, dirs, tmax, exclude_id, max_iters: int = 0,
            counts: bool = False, seen=None):
    """Plain any-hit (shadow) query: t in [0, tmax), excluding
    ``exclude_id`` (kdtree.cpp:283-344); rays stop walking as soon as they
    find a hit.  With ``counts`` also each ray's (steps, leaf triangle
    tests), the tests of an occluding leaf counted up to its first blocker
    (where B2 stops); ``seen`` as in :func:`bvh_closest`."""
    R = origins.shape[0]
    dev = origins.device
    inv = 1.0 / dirs

    occluded = torch.zeros((R,), dtype=torch.bool, device=dev)
    node = torch.zeros((R,), dtype=torch.int32, device=dev)
    steps = torch.zeros((R,), dtype=torch.int32, device=dev)
    tests = torch.zeros((R,), dtype=torch.int32, device=dev)
    limit = step_limit(bvh, max_iters)
    it = 0
    while it < limit and bool((node != SENTINEL).any()):
        active = (node != SENTINEL) & ~occluded
        ni = torch.where(active, node, 0).long()

        hit_box = _box_hit(
            origins, inv, bvh.bbox_min[ni], bvh.bbox_max[ni], tmax
        ) & active
        count = bvh.leaf_count[ni]
        is_leaf = (count > 0) & hit_box
        leaf_count = torch.where(is_leaf, count, 0)

        slots, ok, t, _, _ = _leaf_test(bvh, origins, dirs, bvh.leaf_start[ni], leaf_count)
        blocking = ok & (t < tmax[:, None]) & (bvh.tri_order[slots] != exclude_id[:, None])
        blocked = blocking.any(dim=1)
        occluded = occluded | blocked

        descend = hit_box & (count == 0)
        nxt = torch.where(descend, ni.int() + 1, bvh.miss_link[ni])
        node = torch.where(node != SENTINEL, nxt, node)
        node = torch.where(occluded, SENTINEL, node)
        steps += active.int()
        first = torch.argmax(blocking.int(), dim=1).int() + 1   # the first blocker's slot + 1
        tested = torch.where(blocked, first, leaf_count)
        tests += tested
        _mark_seen(seen, bvh, ni, active, slots, tested)
        it += 1

    return (occluded, (steps, tests)) if counts else occluded


def make_bvh_intersectors(
    scene: SceneTensors, bvh: BVHArrays
) -> Tuple[ClosestFn, AnyFn]:
    """The row-interface pair ``(closest_fn, any_fn)`` over ``bvh``: B1/B2
    on the card (``ops/bvh_cuda.py``), the plain walk for CPU tensors.  No
    ``.planar_fn``: the integrator takes its row path, as in the JAX
    package, and checks there (:func:`check_no_vertex_grad`) the scene it
    is given, which may not be the one the pair was built from."""
    from chiaroscuro_tpu_torch.ops import bvh_cuda

    check_no_vertex_grad(scene)

    def closest_fn(origins, dirs) -> ClosestHit:
        hit, t, tid, u, v = bvh_cuda.closest_bvh(bvh, origins, dirs)
        return ClosestHit(hit, t, tid, u, v)

    def any_fn(origins, dirs, tmax, exclude_id):
        return bvh_cuda.any_bvh(bvh, origins, dirs, tmax, exclude_id)

    closest_fn.bvh = bvh
    return closest_fn, any_fn
