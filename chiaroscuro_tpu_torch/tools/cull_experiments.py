"""The cull formulation shootout on the card, and X1, the row-hit cull: the
counterpart of ``tools/tpu_cull_experiments.py``.

    python -m chiaroscuro_tpu_torch.tools.cull_experiments      # on the card

What it holds:

- :func:`cull_rowhit` is X1 (``_cull_rowhit_call`` -> ``_cull_kernel``): per
  128-ray row and packed box, 1.0 where any lane passes the slab test.  On
  CUDA tensors it launches ``csrc/cull_rowhit.cu`` (built by ``nvcc`` for
  ``sm_90a`` at first use, bound with ``ctypes``) and counts it in
  ``LAUNCHES``; on CPU tensors it takes :func:`cull_rowhit_plain`.
- :func:`cull_rows_kernelized` is the drop-in of ``_cull_rows_kernelized``:
  (meta, ids) in the contract from before the two-phase cull (ids in
  identity order, an overflowing row gets trip = K, no nears or cutoff).
- :func:`rowhit_dot`: the shootout's XLA formulations outside any kernel,
  the chunked dot-reduce (CK = 32, 64) and the scan-free expression, as
  plain torch ops (``torch.matmul`` for their ``dot_general``).
- :func:`main` times today's cull (K3, ``ops/cluster_cuda.cull``) beside
  those and X1 on the primary rays of ``synthetic:atrium:19000`` (nanosuit's
  triangle count; its OBJ is not in the repo) at 1024x1024, and checks that
  they agree.  The JAX script's ``main`` no longer runs: it unpacks today's
  4-tuple cull into two values and reads a scene outside the repo.  This
  one measures what it set out to, under today's contract.
"""

from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch

from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
from chiaroscuro_tpu_torch.ops.cuda_build import bind, check_launch
from chiaroscuro_tpu_torch.ops.intersect_cuda import BIG, LANE, _check, _launch_device

# Kernel launches; incremented only where the wrapper launches X1.
LAUNCHES = {"cull_rowhit": 0}

BOX_W = 8                  # packed box row: bmin xyz | bmax xyz | pad pad
SCENE_TRIS = 19_000        # synthetic:atrium:19000, K = 148
RES = 1024
LMAX = 128


def pack_cull_boxes(bbox_min: np.ndarray, bbox_max: np.ndarray) -> np.ndarray:
    """(K, 3) + (K, 3) -> (ceil(K/128)*128, 8) f32 rows for X1; padded rows
    hold inverted boxes (BIG, -BIG), as the XLA cull pads."""
    K = bbox_min.shape[0]
    KB = -(-K // 128) * 128
    boxes = np.zeros((KB, BOX_W), np.float32)
    boxes[:K, 0:3] = bbox_min
    boxes[:K, 3:6] = bbox_max
    boxes[K:, 0:3] = BIG
    boxes[K:, 3:6] = -BIG
    return boxes


def cull_rowhit_plain(o3, d3, boxes, tmax=None):
    """Plain torch X1: (B0, KB) f32, 1.0 where any of row b's 128 lanes hits
    packed box j.  Padded (inverted) boxes test as the infinite box, so
    their columns are 1.0 in every row, as on the TPU
    (``cluster_pallas.py:137-140``).  The reciprocals are K3's
    (``_safe_inv``): ``_cull_kernel``'s ``mag != 0`` (:73) selects the same
    values, since ``mag * HUGE_INV >= 1`` already excludes ``mag == 0``."""
    hit, _ = cc._rowhit_scan(o3, cc._safe_inv(d3), boxes[:, 0:3], boxes[:, 3:6], tmax)
    return hit.to(torch.float32)


@functools.cache
def build() -> tuple:
    """Build and load ``csrc/cull_rowhit.cu`` (``ops/cuda_build.py``);
    returns ``(lib, info)``.  A failed build raises."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return bind("cull_rowhit", {"cull_rowhit_launch": [vp] * 4 + [ci, ci, vp, vp]})


def cull_rowhit(o3, d3, boxes, tmax=None):
    """X1: o3, d3 (3, B0, 128) f32; boxes (KB, 8) f32 from
    :func:`pack_cull_boxes`, KB a multiple of 128; tmax None or (B0, 128)
    f32 (then a box counts only where near <= tmax).  Returns (B0, KB) f32
    0/1; callers slice [:, :K].  The inputs are taken detached."""
    o3, d3 = o3.detach(), d3.detach()
    tmax = None if tmax is None else tmax.detach()
    device = _launch_device(o3, d3, boxes)
    B0, KB = o3.shape[1], boxes.shape[0]
    _check("o3", o3, (3, B0, LANE), torch.float32, device)
    _check("d3", d3, (3, B0, LANE), torch.float32, device)
    _check("boxes", boxes, (KB, BOX_W), torch.float32, device)
    if tmax is not None:
        _check("tmax", tmax, (B0, LANE), torch.float32, device)
    if KB % 128:
        raise ValueError(f"boxes has {KB} rows, not a multiple of 128 (pack_cull_boxes)")
    if device.type == "cpu":
        return cull_rowhit_plain(o3, d3, boxes, tmax)
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned")
    lib, _ = build()
    out = torch.empty((B0, KB), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.cull_rowhit_launch(
            o3.data_ptr(), d3.data_ptr(), None if tmax is None else tmax.data_ptr(),
            boxes.data_ptr(), B0, KB, out.data_ptr(), stream)
    check_launch(lib, err, "cull_rowhit")
    LAUNCHES["cull_rowhit"] += 1
    return out


def old_contract_lists(rowhit, K, Lmax):
    """(B0, K) bool hit mask -> (meta, ids) in the contract from before the
    two-phase cull, as the JAX shootout builds it with ``lax.top_k``: ids
    are the row's hits in ascending id, then its misses in ascending id,
    Le = min(Lmax, K) wide; a row with more than Le hits gets trip = K
    (overflow = 1), else trip = its hit count.  ``lax.top_k`` puts the lower
    index first among equal values; a stable descending sort does the
    same."""
    count = rowhit.sum(dim=1, dtype=torch.int32)
    Le = min(Lmax, K)
    _, ids = torch.sort(rowhit.to(torch.int32), dim=1, descending=True, stable=True)
    overflow = count > Le
    trip = torch.where(overflow, K, count)
    meta = torch.stack([trip, overflow.to(torch.int32)], dim=1)
    return meta, ids[:, :Le].to(torch.int32).contiguous()


def cull_rows_kernelized(o3, d3, boxes, K, Lmax, tmax=None):
    """Drop-in of ``_cull_rows_kernelized``: X1's row hits, then
    :func:`old_contract_lists`.  Returns (meta, ids)."""
    rowhit = cull_rowhit(o3, d3, boxes, tmax)[:, :K] > 0.0
    return old_contract_lists(rowhit, K, Lmax)


def rowhit_dot(o3, d3, bmin, bmax, CK=None):
    """The shootout's XLA formulations: per chunk of CK boxes the slab test
    over (CK, B0, 128), the lane reduction as a product with a ones column
    (the TPU's MXU); ``CK=None`` is the scan-free expression (all K boxes
    at once, padded to a multiple of 8).  Boxes are padded with inverted
    ones and sliced off.  Returns the (B0, K) bool hit mask."""
    K = bmin.shape[0]
    CK = CK or -(-K // 8) * 8
    Kp = -(-K // CK) * CK
    dev = o3.device
    bmn = torch.cat([bmin, torch.full((Kp - K, 3), BIG, device=dev)])
    bmx = torch.cat([bmax, torch.full((Kp - K, 3), -BIG, device=dev)])
    inv = cc._safe_inv(d3)
    ones = torch.ones((LANE, 1), dtype=torch.float32, device=dev)
    chunks = []
    for base in range(0, Kp, CK):
        cmn, cmx = bmn[base:base + CK], bmx[base:base + CK]
        near = far = None
        for a in range(3):
            t0 = (cmn[:, a, None, None] - o3[a][None]) * inv[a][None]
            t1 = (cmx[:, a, None, None] - o3[a][None]) * inv[a][None]
            lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
            near = lo if near is None else torch.maximum(near, lo)
            far = hi if far is None else torch.minimum(far, hi)
        hit = ((far >= near) & (far >= 0.0)).to(torch.float32)
        cnt = torch.matmul(hit.reshape(-1, LANE), ones)
        chunks.append(cnt.reshape(CK, -1) > 0.0)
    return torch.cat(chunks).T[:, :K]


def k3_rowhit(o3, d3, bmin, bmax, tmax=None):
    """K3's (B0, K) hit mask: its sweep's hit output (``cluster_cuda.
    cull_sweep``: the kernel on CUDA tensors, the plain sweep on CPU
    tensors)."""
    return cc.cull_sweep(o3, d3, bmin, bmax, tmax, hits=True)[2]


def primary_rays(cam, xres, yres, dev):
    """Primary rays with zero jitter, as the JAX script makes them: (o3,
    d3), each (3, xres * yres / 128, 128), rows in pixel order."""
    from chiaroscuro_tpu_torch.geometry.camera import camera_basis, primary_ray_dirs_planar

    B = (xres * yres // LANE, LANE)
    lu, dx, dy = (torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in
                  camera_basis(cam["eye"], cam["center"], cam["up"], cam["yview"], xres, yres))
    ys, xs = torch.meshgrid(torch.arange(yres, device=dev), torch.arange(xres, device=dev),
                            indexing="ij")
    z = torch.zeros(B, device=dev)
    d3 = primary_ray_dirs_planar(lu, dx, dy, xs.reshape(B).float(), ys.reshape(B).float(),
                                 z, z).contiguous()
    o3 = torch.tensor(cam["eye"], dtype=torch.float32, device=dev)[:, None, None]
    return o3.expand((3,) + B).contiguous(), d3


def timed(tag, fn, dev, iters=3):
    """Best of ``iters`` calls after one warm call, in ms: CUDA events on a
    card, the host clock on the CPU.  Prints a line, returns (out, ms)."""
    out = fn()
    best = float("inf")
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    print(f"{tag:<46s} {best:8.3f} ms", flush=True)
    return out, best


def _id_sets(meta, ids, K):
    """(B0, K) bool: the first trip ids of each row, as a set."""
    B0, Le = ids.shape
    listed = torch.arange(Le, device=ids.device)[None] < meta[:, :1]
    sets = torch.zeros((B0, K + 1), dtype=torch.bool, device=ids.device)
    sets.scatter_(1, torch.where(listed, ids, K).long(), True)
    return sets[:, :K]


def main(device="cuda"):
    """The shootout on ``synthetic:atrium:19000`` with 1024x1024 primary
    rays from ``ATRIUM_CAMERA`` and lists 128 wide.  Times (best of 3)
    today's cull K3, the dot-reduce at CK = 32 and 64, the scan-free
    expression and X1, each with its list epilogue, and raises unless

    - X1 equals its plain version exactly, its padded columns 1.0;
    - every formulation's hit mask equals K3's, exactly;
    - every old-contract (meta, ids) equals the others';
    - against K3's lists, the overflow flags agree on every row, and trip
      and the id set on every row that does not overflow (the JAX test's
      form, ``tests/test_cluster.py:294``).

    Returns {"K", "B0", "overflow_rows", "ms": {tag: ms}}.  Without a card,
    and without ``device="cpu"``, it raises."""
    return _shootout(torch.device(device), SCENE_TRIS, RES, LMAX)


def _shootout(dev, tris, res, lmax):
    """:func:`main` on ``synthetic:atrium:<tris>`` at res x res, lists lmax
    wide (the CPU tests run it small)."""
    from chiaroscuro_tpu_torch.accel.clusters import build_clusters
    from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA, atrium

    scene = build_scene_tensors(atrium(tris), device=dev)
    ca = build_clusters(*(x.cpu().numpy() for x in (scene.tri_v0, scene.tri_v1, scene.tri_v2)))
    bmin = torch.from_numpy(ca.bbox_min).to(dev)
    bmax = torch.from_numpy(ca.bbox_max).to(dev)
    boxes = torch.from_numpy(pack_cull_boxes(ca.bbox_min, ca.bbox_max)).to(dev)
    K = ca.K
    o3, d3 = primary_rays(ATRIUM_CAMERA, res, res, dev)
    B0 = o3.shape[1]
    print(f"synthetic:atrium:{tris}: T={scene.n_tris} K={K}; {res}x{res} primary rays, "
          f"B0={B0}, Lmax={lmax}", flush=True)
    del scene

    def lists_of(mask_fn):
        def run():
            mask = mask_fn()
            return (mask, *old_contract_lists(mask, K, lmax))
        return run

    ms = {}
    k3_lists, ms["K3 cull (ops/cluster_cuda.cull)"] = timed(
        "K3 cull (ops/cluster_cuda.cull)",
        lambda: cc.cull(o3, d3, bmin, bmax, min(lmax, K)), dev)
    k3_mask = k3_rowhit(o3, d3, bmin, bmax)
    variants = {}
    for CK in (32, 64):
        tag = f"dot-reduce CK={CK} + sort"
        variants[tag], ms[tag] = timed(tag, lists_of(lambda CK=CK: rowhit_dot(o3, d3, bmin, bmax, CK)), dev)
    tag = "dot-reduce scan-free (full K) + sort"
    variants[tag], ms[tag] = timed(tag, lists_of(lambda: rowhit_dot(o3, d3, bmin, bmax)), dev)
    tag = "X1 row-hit kernel + sort"
    x1 = {}

    def x1_mask():
        x1["rowhit"] = cull_rowhit(o3, d3, boxes)
        return x1["rowhit"][:, :K] > 0.0

    variants[tag], ms[tag] = timed(tag, lists_of(x1_mask), dev)
    # The last timed call's output: no launch beyond the timed ones.
    if not torch.equal(x1["rowhit"], cull_rowhit_plain(o3, d3, boxes)):
        raise AssertionError("X1 differs from its plain version")
    if not bool((x1["rowhit"][:, K:] == 1.0).all()):
        raise AssertionError("X1's padded columns are not 1.0 in every row")
    print(f"X1 equals its plain version on all {B0} x {boxes.shape[0]} (row, box) pairs, "
          f"its {boxes.shape[0] - K} padded columns 1.0", flush=True)

    meta0, ids0 = next(iter(variants.values()))[1:]
    for tag, (mask, meta, ids) in variants.items():
        if not torch.equal(mask, k3_mask):
            raise AssertionError(f"{tag}: hit mask differs from K3's")
        if not (torch.equal(meta, meta0) and torch.equal(ids, ids0)):
            raise AssertionError(f"{tag}: (meta, ids) differ from the other formulations'")
    print("every formulation's hit mask equals K3's; (meta, ids) equal across them", flush=True)

    k3_meta = k3_lists[0]
    over = k3_meta[:, 1].bool()
    if not torch.equal(over, meta0[:, 1].bool()):
        raise AssertionError("overflow flags differ from K3's")
    keep = ~over
    if not (torch.equal(k3_meta[keep, 0], meta0[keep, 0])
            and torch.equal(_id_sets(k3_meta, k3_lists[1], K)[keep],
                            _id_sets(meta0, ids0, K)[keep])):
        raise AssertionError("trip or id sets differ from K3's on rows that do not overflow")
    n_over = int(over.sum())
    print(f"old contract vs K3's lists: overflow flags equal on all {B0} rows ({n_over} "
          f"overflow); trip and id sets equal on the other {B0 - n_over}", flush=True)
    return {"K": K, "B0": B0, "overflow_rows": n_over, "ms": ms}


if __name__ == "__main__":
    main()
