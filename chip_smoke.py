#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``chiaroscuro_tpu_torch`` on the card in these phases; any failure
raises, exits non-zero and prints no result line.

1. Device and build: the card's name and power limit (nvidia-smi), torch's
   device name and count.  The CUDA sources (``csrc/intersect_dense.cu``
   K1/K2, ``csrc/intersect_cluster.cu`` K6/K7) build in parallel, one nvcc
   each, while the Triton cull K3 (``ops/cull_triton.py``) compiles; build
   seconds, registers, shared memory and spills are printed.
2. Dense kernels vs plain: K1/K2 against their plain torch versions at
   Cornell (T = 36) and a seeded random soup (T = 4,096), B0 = 4,608 rows
   (one 768x768 wavefront) with a third of the rows dead: bitwise equal.
2b. Cluster kernels vs plain at the full atrium (481,208 triangles,
   K = 3,760 clusters of 128, streaming): the primary wavefront of the
   1280x720 ``ATRIUM_CAMERA`` frame (B0 = 7,200), one cosine-sampled bounce
   wavefront from its hits and the NEE shadow wavefront, each sorted as the
   integrator sorts it on this path.  K3 must equal its plain version
   exactly on every row (closest and shadow queries); K6/K7 must be bitwise
   equal to theirs on a seeded sample of rows plus every row that overflowed
   its list.  The same checks then run on every row of atrium(2_200,
   seed=5) at M = 32 with lists short enough to overflow.
3. Cornell render: the CLI's batch render of ``scenes/cornell.rtc`` at its
   768x768 and k 6, 16 spp, into an EXR in a temporary directory that is
   read back; finite, non-trivial, one K1 and one K2 launch per sample x
   bounce.  A 128x128, 4 spp, k 6 render on the card is held against the
   same render on the CPU (the plain versions).
3b. Atrium render: the CLI renders ``synthetic:atrium`` at 1280x720, 1 spp,
   k 3 with ``intersector auto`` and the ATRIUM_CAMERA view into an EXR that
   is read back: finite and lit (median over 4x4-pixel block means of the
   per-pixel max > 1e-3), and auto must have taken the cluster path
   (2 K3, 1 K6 and 1 K7 launch per sample x bounce, no dense launch).  Then
   atrium(2_200) at 160x90, 2 spp, k 2 through ``intersector cluster`` on
   the card is held against the CPU render, and the card's compacted render
   (spatial sort forced on) must be bitwise equal to its uncompacted one.
4. Timings (CUDA events, with the card's name and power limit): every
   kernel vs its plain version in us per launch, the atrium frame's set-up
   seconds apart from its render, ms per frame, useful Mray/s and peak
   device memory.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B0 = 4608                  # rows of 128 lanes in one 768x768 wavefront
SOUP_TRIS = 4096           # the largest scene the dense path serves
RENDER_SPP = 16
RENDER_K = 6
ATRIUM_RES = (1280, 720)   # the bench's sponza-scale headline frame
ATRIUM_K = 3
ROW_SAMPLE = 256           # seeded rows for the plain K6/K7 comparisons
SMALL_LMAX = 32            # lists short enough that most atrium(2_200) rows overflow
PIXEL_ORDER_LMAX = 512     # list width for the pixel-order bounce block


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def sync():
    torch.cuda.synchronize()


def bits(x):
    """Bit pattern of a float tensor (bitwise comparison), else itself."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def max_err(a, b):
    finite = torch.isfinite(a.double()) & torch.isfinite(b.double())
    d = (a.double() - b.double()).abs()[finite]
    return float(d.max()) if d.numel() else 0.0


def make_queries(rng, lo, hi, n_tris, dev):
    """Seeded rays over a scene's bounds, a third of the rows dead, and
    shadow-query limits and exclusions."""
    R = B0 * 128
    ext = hi - lo
    o = rng.uniform(lo - 0.1 * ext, hi + 0.1 * ext, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    live = (rng.uniform(size=B0) >= 1.0 / 3.0).astype(np.int32)
    tmax = rng.uniform(0.0, 1.5 * float(ext.max()), R).astype(np.float32)
    excl = rng.integers(0, n_tris, R).astype(np.int32)

    def planar(x):
        return torch.from_numpy(np.ascontiguousarray(x.T.reshape(3, B0, 128))).to(dev)

    return dict(
        live=torch.from_numpy(live).to(dev),
        o3=planar(o),
        d3=planar(d),
        tmax=torch.from_numpy(tmax.reshape(B0, 128)).to(dev),
        excl=torch.from_numpy(excl.reshape(B0, 128)).to(dev),
    )


def soup(rng, n, dev):
    """A seeded soup of n small triangles in the unit cube, with random
    attribute rows."""
    v0 = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(scale=0.08, size=(n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(scale=0.08, size=(n, 3)).astype(np.float32)
    attrs = rng.normal(size=(n, 32)).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (v0, v1, v2, attrs)]
    lo = np.minimum(v0, np.minimum(v1, v2)).min(0)
    hi = np.maximum(v0, np.maximum(v1, v2)).max(0)
    return t, lo, hi


def compare_kernels(ic, name, tri_rows, attrs, q):
    """Phase 2 for one scene; returns the largest |kernel - plain| seen."""
    k = ic.closest_dense(q["live"], q["o3"], q["d3"], tri_rows, attrs)
    p = ic.closest_dense_plain(q["live"], q["o3"], q["d3"], tri_rows, attrs)
    ko = ic.any_dense(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], tri_rows)
    po = ic.any_dense_plain(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], tri_rows)
    sync()
    fields = ("t", "id", "u", "v", "attrs")
    err = 0.0
    bad = []
    for f, a, b in zip(fields, k, p):
        if not torch.equal(a, b):
            bad.append(f)
        err = max(err, float((a.double() - b.double()).abs().max()))
    if not torch.equal(ko, po):
        bad.append("occluded")
    live_lanes = q["live"].bool()[:, None].expand(B0, 128)
    hit = k[0] < ic.BIG
    hit_share = float(hit[live_lanes].float().mean())
    occ_share = float(ko[live_lanes].float().mean())
    print(
        f"[kernels] {name}: T={tri_rows.shape[0]} B0={B0} live rows="
        f"{int(q['live'].sum())} hit share={hit_share:.4f} occluded share="
        f"{occ_share:.4f} max|kernel-plain|={err} mismatched={bad or 'none'}"
    )
    if bad:
        raise AssertionError(f"{name}: kernel differs from plain in {bad}")
    if not (0.01 < hit_share < 0.99 and 0.01 < occ_share < 0.99):
        raise AssertionError(f"{name}: trivial queries (hit {hit_share}, occ {occ_share})")
    if bool(hit[~live_lanes].any()) or bool(ko[~live_lanes].any()):
        raise AssertionError(f"{name}: a dead row reported a hit")
    return err


def time_us(fn, reps):
    """Microseconds per call of fn over reps calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) * 1e3 / reps


def time_pair(fn_kernel, fn_plain, reps_kernel=50, reps_plain=3):
    """Microseconds per launch, plain/kernel/kernel/plain, CUDA events."""
    fn_kernel(), fn_plain()
    sync()
    p1 = time_us(fn_plain, reps_plain)
    k1 = time_us(fn_kernel, reps_kernel)
    k2 = time_us(fn_kernel, reps_kernel)
    p2 = time_us(fn_plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2), (p1, p2)


def assert_render_close(img, ref, what, mean_rel=1e-4, outlier_share=0.005,
                        flipped_mean_rel=None):
    """The CPU tests' bound (tests/test_torch_render.py): mean |d| <=
    mean_rel x mean radiance and at most outlier_share of the pixels outside
    rtol 1e-3.  With ``flipped_mean_rel``, the mean bound holds over the
    pixels inside rtol 1e-3, and the whole image's mean |d| over all pixels
    is held to flipped_mean_rel x mean instead: there the few outside pixels
    are paths that an ulp of a CUDA vs CPU transcendental turned, which can
    carry a light's whole radiance."""
    diff = np.abs(img - ref)
    inside = np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    mean_abs = float(diff.mean())
    mean_in = float(diff[inside].mean())
    outside = float((~inside).mean())
    print(f"[render] {what} card vs cpu: mean|d|/mean={mean_abs / float(ref.mean())}, "
          f"over pixels inside rtol 1e-3 {mean_in / float(ref.mean())}; outside rtol 1e-3: "
          f"{outside} ({int((~inside).sum())} of {inside.size} pixels)")
    if flipped_mean_rel is None:
        ok = mean_abs <= mean_rel * float(ref.mean())
    else:
        ok = (mean_in <= mean_rel * float(ref.mean())
              and mean_abs <= flipped_mean_rel * float(ref.mean()))
    if not (np.isfinite(img).all() and ok and outside <= outlier_share):
        raise AssertionError(f"{what}: card render differs from the CPU render")


def reset(counts):
    for key in counts:
        counts[key] = 0


# ---------------------------------------------------------------------------
# Phase 2b helpers: the atrium's wavefronts and the cluster comparisons.
# ---------------------------------------------------------------------------


def atrium_wavefronts(scene, xres, yres, dev):
    """The frame's primary wavefront in pixel order, the first bounce from
    its hits (cosine-sampled with the port's samplers, sorted by the
    integrator's spatial key as the cluster path sorts it, dead lanes
    parked; and a block of ROW_SAMPLE rows of it in pixel order) and the NEE
    shadow wavefront from the same hits (sorted by light and cell as
    ``_sorted_any`` sorts it).  Returns {name: (o3, d3,
    tmax or None, excl or None)} and the primary hit share."""
    from chiaroscuro_tpu_torch.geometry import planar as P
    from chiaroscuro_tpu_torch.geometry.camera import camera_basis, primary_ray_dirs_planar
    from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
    from chiaroscuro_tpu_torch.render import integrator as I
    from chiaroscuro_tpu_torch.sampling import prng
    from chiaroscuro_tpu_torch.sampling.samplers import sample_wi_diffuse_planar
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA as cam

    B = (xres * yres // 128, 128)
    lu, dx, dy = (torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in
                  camera_basis(cam["eye"], cam["center"], cam["up"], cam["yview"], xres, yres))
    ys, xs = torch.meshgrid(torch.arange(yres, device=dev), torch.arange(xres, device=dev),
                            indexing="ij")
    k0, k1 = prng.base_key(0, (ys * xres + xs).reshape(B), 0)
    jx, jy = prng.aa_jitter_pair(k0, k1)
    d3 = primary_ray_dirs_planar(lu, dx, dy, xs.reshape(B).float(), ys.reshape(B).float(),
                                 jx, jy).contiguous()
    o3 = torch.tensor(cam["eye"], dtype=torch.float32, device=dev)[:, None, None]
    o3 = o3.expand((3,) + B).contiguous()
    cf, _ = cc.make_cluster_intersectors(scene, stream=True)
    res = cf.planar_fn(o3, d3)
    hit, A = res.hit, res.attrs
    w = 1.0 - res.u - res.v
    point = P.pscale(w, A["v0"]) + P.pscale(res.u, A["v0"] + A["e1"]) \
        + P.pscale(res.v, A["v0"] + A["e2"])
    normal = A["normal"]
    un = prng.bounce_uniforms_planar(k0, k1, 1)
    wmin = scene.world_min
    wext = torch.clamp_min(scene.world_max - wmin, 1e-6)
    park_x = scene.world_max[0] + (scene.world_max[0] - wmin[0]) + 1.0
    zero = torch.zeros(B, device=dev)
    park_o = torch.stack([park_x.expand(B), zero, zero])
    park_d = torch.stack([torch.ones_like(zero), zero, zero])
    origin = P.pwhere(hit, point + I.EPS_OFFSET * normal, park_o)

    wi, _ = sample_wi_diffuse_planar(normal, un[prng.DIM_BSDF_U], un[prng.DIM_BSDF_V])
    bdir = P.pwhere(hit, wi, park_d)
    key = I._spatial_key(origin, bdir, hit, wmin, wext)
    sm = I._compact(key, torch.cat([origin.reshape(3, -1), bdir.reshape(3, -1)]), 1, B[0] * B[1])

    n_l = scene.n_lights
    li = torch.clamp_max((un[prng.DIM_LIGHT_SEL] * n_l).to(torch.int32), n_l - 1).long()
    lids = scene.light_ids.long()
    lv = [scene.tri_v0[lids][li], scene.tri_v1[lids][li], scene.tri_v2[lids][li]]
    b0 = un[prng.DIM_LIGHT_U]
    b1 = un[prng.DIM_LIGHT_V] * (1.0 - b0)
    lpoint = (lv[0] * b0[..., None] + lv[1] * b1[..., None]
              + lv[2] * (1.0 - b0 - b1)[..., None]).permute(2, 0, 1)
    to_light = lpoint - point
    dist = P.pnorm(to_light)
    sdir = P.pwhere(hit, P.pnormalize(to_light), park_d)
    skey = (((~hit).to(torch.int32) << 26) | (torch.clamp_max(li, 1023).to(torch.int32) << 16)
            | I._morton_cell(origin, wmin, wext))
    ss = I._compact(skey, torch.cat([
        origin.reshape(3, -1), sdir.reshape(3, -1), dist.reshape(1, -1),
        I._f32_bits(scene.light_ids[li]).reshape(1, -1)]), 1, B[0] * B[1])

    def planar(x):
        return x.reshape((3,) + B).contiguous()

    # A block of rows of the bounce wavefront in pixel order, as a render
    # without compaction traces it: its rows mix directions and hit ~800 of
    # the atrium's boxes, so with 512-wide lists (a width the JAX package's
    # sweep measured) they overflow and K6's phase 2 runs at full scale.
    blk = slice(max(0, B[0] // 2 - ROW_SAMPLE // 2), B[0] // 2 + ROW_SAMPLE // 2)
    waves = {
        "primary": (o3, d3, None, None),
        "bounce": (planar(sm[0:3]), planar(sm[3:6]), None, None),
        "bounce in pixel order": (origin[:, blk].contiguous(), bdir[:, blk].contiguous(),
                                  None, None, PIXEL_ORDER_LMAX),
        "shadow": (planar(ss[0:3]), planar(ss[3:6]), ss[6].reshape(B).contiguous(),
                   ss[7].view(torch.int32).reshape(B).contiguous()),
    }
    return waves, float(hit.float().mean())


def compare_cluster(cc, name, waves, bmin, bmax, Le, packed, attrs, rng, all_rows):
    """K3 exact on every row and K6/K7 bitwise on a row sample (every row
    when ``all_rows``; else ROW_SAMPLE seeded rows plus every overflow
    row), for each wavefront.  Returns the largest |kernel - plain| per
    kernel and the compared inputs for the timings."""
    errs = {"cull": 0.0, "closest_cluster": 0.0, "any_cluster": 0.0}
    inputs = {}
    n_overflow_sampled = 0
    for wname, (o3, d3, tmax, excl, *le) in waves.items():
        wle = min(le[0], Le) if le else Le
        lists = cc.cull(o3, d3, bmin, bmax, wle, tmax=tmax)
        plain = cc.cull_plain(o3, d3, bmin, bmax, wle, tmax=tmax)
        sync()
        for field, a, b in zip(("meta", "ids", "nears", "cutoff"), lists, plain):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}/{wname}: K3 differs from plain in {field}")
        errs["cull"] = max(errs["cull"], max_err(lists[2], plain[2]))
        meta = lists[0]
        nB0 = o3.shape[1]
        overflow = torch.nonzero(meta[:, 1]).reshape(-1)
        if all_rows:
            rows = torch.arange(nB0, device=o3.device)
        else:
            pick = torch.from_numpy(rng.choice(nB0, min(ROW_SAMPLE, nB0), replace=False))
            rows = torch.unique(torch.cat([pick.to(o3.device), overflow]))
        n_overflow_sampled += int(meta[rows, 1].sum())
        sub = tuple(x[rows].contiguous() for x in lists)
        so3, sd3 = o3[:, rows].contiguous(), d3[:, rows].contiguous()
        if tmax is None:
            got = cc.closest_cluster(*lists, o3, d3, packed, attrs)
            want = cc.closest_cluster_plain(*sub, so3, sd3, packed, attrs)
            sync()
            fields = zip(("t", "id", "u", "v", "attrs"), got, want)
            bad = [f for f, a, b in fields
                   if not torch.equal(bits(a[..., rows, :] if a.dim() == 3 else a[rows]), bits(b))]
            errs["closest_cluster"] = max(
                [errs["closest_cluster"]] + [max_err(a[..., rows, :] if a.dim() == 3 else a[rows], b)
                                             for a, b in zip(got, want)])
            kernel = "K6"
            share = float((got[0] < cc.BIG).float().mean())
        else:
            got = cc.any_cluster(*lists, o3, d3, tmax, excl, packed)
            want = cc.any_cluster_plain(*sub, so3, sd3, tmax[rows].contiguous(),
                                        excl[rows].contiguous(), packed)
            sync()
            bad = [] if torch.equal(got[rows], want) else ["occluded"]
            errs["any_cluster"] = max(errs["any_cluster"], max_err(got[rows].float(), want.float()))
            kernel = "K7"
            share = float(got.float().mean())
        trip = meta[:, 0].float()
        print(f"[cluster] {name}/{wname}: B0={nB0} Le={wle} trip p50={float(trip.median())} "
              f"max={int(meta[:, 0].max())} overflow share={float(meta[:, 1].float().mean()):.5f} "
              f"({overflow.numel()} rows); {kernel} on {rows.numel()} rows "
              f"({int(meta[rows, 1].sum())} overflow): {'hit' if tmax is None else 'occluded'} "
              f"share {share:.4f}, mismatched={bad or 'none'}")
        if bad:
            raise AssertionError(f"{name}/{wname}: {kernel} differs from plain in {bad}")
        inputs[wname] = (o3, d3, tmax, excl, lists, wle)
    print(f"[cluster] {name}: K3 equals plain on every row; K6/K7 bitwise on the samples "
          f"({n_overflow_sampled} overflow rows among them)")
    return errs, inputs, n_overflow_sampled


def time_cluster(cc, inputs, bmin, bmax, packed, attrs, rng):
    """K3 on every row and K6/K7 on ROW_SAMPLE seeded rows, each against
    its plain version on the same rows; K6/K7 also on every row."""
    timings = {}
    for wname, (o3, d3, tmax, excl, lists, wle) in inputs.items():
        pick = torch.from_numpy(rng.choice(o3.shape[1], ROW_SAMPLE, replace=False)).to(o3.device)
        sub = tuple(x[pick].contiguous() for x in lists)
        so3, sd3 = o3[:, pick].contiguous(), d3[:, pick].contiguous()
        timings[("cull", wname)] = time_pair(
            lambda: cc.cull(o3, d3, bmin, bmax, wle, tmax=tmax),
            lambda: cc.cull_plain(o3, d3, bmin, bmax, wle, tmax=tmax),
            reps_kernel=10, reps_plain=1,
        )
        if tmax is None:
            name = "closest_cluster"
            full = lambda: cc.closest_cluster(*lists, o3, d3, packed, attrs)  # noqa: E731
            kern = lambda: cc.closest_cluster(*sub, so3, sd3, packed, attrs)  # noqa: E731
            plain = lambda: cc.closest_cluster_plain(*sub, so3, sd3, packed, attrs)  # noqa: E731
        else:
            name = "any_cluster"
            stm, sex = tmax[pick].contiguous(), excl[pick].contiguous()
            full = lambda: cc.any_cluster(*lists, o3, d3, tmax, excl, packed)  # noqa: E731
            kern = lambda: cc.any_cluster(*sub, so3, sd3, stm, sex, packed)  # noqa: E731
            plain = lambda: cc.any_cluster_plain(*sub, so3, sd3, stm, sex, packed)  # noqa: E731
        timings[(name, wname)] = time_pair(kern, plain, reps_kernel=10, reps_plain=1)
        timings[(name + " all rows", wname)] = time_us(full, 10)
        timings[("rows", wname)] = (o3.shape[1], wle, float(lists[0][:, 0].float().median()),
                                    float(sub[0][:, 0].float().median()))
    return timings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from chiaroscuro_tpu_torch import cli
    from chiaroscuro_tpu_torch.accel.clusters import build_clusters
    from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
    from chiaroscuro_tpu_torch.ops import cull_triton
    from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
    from chiaroscuro_tpu_torch.render.image_io import read_exr
    from chiaroscuro_tpu_torch.render.renderer import render_image, render_samples
    from chiaroscuro_tpu_torch.scene.builtin import cornell_box
    from chiaroscuro_tpu_torch.scene.config import RenderConfig
    from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors, load_scene
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA, atrium

    repo = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    # --- phase 1: device and build ------------------------------------------
    print(f"[device] nvidia-smi: {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {kind} x{count}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(ic.build), pool.submit(cc.build)]
        # Meanwhile compile both Triton variants with one tiny launch each.
        t_tri = time.perf_counter()
        # (B0 and K multiples of 16, as at the atrium: Triton specializes on it.)
        o = torch.zeros((3, 16, 128), device=dev)
        box = torch.zeros((16, 3), device=dev)
        cull_triton.rowhit(o, o, box, box)
        cull_triton.rowhit(o, o, box, box, tmax=torch.zeros((16, 128), device=dev))
        sync()
        t_tri = time.perf_counter() - t_tri
        infos = [f.result()[1] for f in builds]
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s; Triton K3 compile "
          f"{t_tri:.2f} s (cache {os.environ.get('TRITON_CACHE_DIR')})")
    for line in cull_triton.compile_report():
        print(f"[build] {line}")
    for info in infos:
        print(f"[build] {os.path.relpath(info['path'], repo)}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {line.strip()}")

    # --- phase 2: dense kernels vs plain ---------------------------------------
    rng = np.random.default_rng(20261016)
    cornell = build_scene_tensors(cornell_box(), device=dev)
    c_rows = ic._prep_tris(cornell.tri_v0, cornell.tri_v1, cornell.tri_v2)
    c_attrs = ic._prep_attrs(cornell)
    c_q = make_queries(rng, cornell.world_min.cpu().numpy(),
                       cornell.world_max.cpu().numpy(), cornell.n_tris, dev)
    (sv0, sv1, sv2, s_attrs), s_lo, s_hi = soup(rng, SOUP_TRIS, dev)
    s_rows = ic._prep_tris(sv0, sv1, sv2)
    s_q = make_queries(rng, s_lo, s_hi, SOUP_TRIS, dev)
    with torch.no_grad():
        err = max(
            compare_kernels(ic, "cornell", c_rows, c_attrs, c_q),
            compare_kernels(ic, "soup", s_rows, s_attrs, s_q),
        )
    print("[kernels] K1/K2 equal their plain versions bitwise")
    sync()

    # --- phase 2b: cluster kernels vs plain ------------------------------------
    t0 = time.perf_counter()
    big = build_scene_tensors(atrium(480_000), device=dev)
    sync()
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    ca = build_clusters(*(x.cpu().numpy() for x in (big.tri_v0, big.tri_v1, big.tri_v2)))
    packed, attrs = cc.derive_buffers(big, ca)
    bmin = torch.from_numpy(ca.bbox_min).to(dev)
    bmax = torch.from_numpy(ca.bbox_max).to(dev)
    sync()
    t_clusters = time.perf_counter() - t0
    Le = min(cc.DEFAULT_LMAX, ca.K)
    print(f"[cluster] atrium: T={big.n_tris} lights={big.n_lights} K={ca.K} M={ca.M} "
          f"stream={cc.streams_by_budget(ca.K, ca.M)} (packed {ca.K * ca.M * cc.PACK_W * 4 / 2**20:.1f} "
          f"MiB by the JAX rule); scene {t_scene:.2f} s, clusters + buffers {t_clusters:.2f} s")
    if (big.n_tris, ca.K) != (481_208, 3_760) or not cc.streams_by_budget(ca.K, ca.M):
        raise AssertionError("the full atrium is no longer the 481,208-triangle streaming scene")
    with torch.no_grad():
        waves, primary_hits = atrium_wavefronts(big, *ATRIUM_RES, dev)
        if waves["primary"][0].shape[1] != 7200 or primary_hits < 0.99:
            raise AssertionError(f"atrium primary wavefront: B0 or hit share {primary_hits} off")
        big_errs, big_inputs, n_over = compare_cluster(
            cc, "atrium 1280x720", waves, bmin, bmax, Le, packed, attrs, rng, all_rows=False)
        small = build_scene_tensors(atrium(2_200, seed=5), device=dev)
        sca = build_clusters(*(x.cpu().numpy() for x in (small.tri_v0, small.tri_v1, small.tri_v2)), 32)
        s_packed, s_attrs2 = cc.derive_buffers(small, sca)
        s_waves, _ = atrium_wavefronts(small, 160, 96, dev)
        small_errs, _, s_over = compare_cluster(
            cc, "atrium(2_200) M=32", s_waves, torch.from_numpy(sca.bbox_min).to(dev),
            torch.from_numpy(sca.bbox_max).to(dev), SMALL_LMAX, s_packed, s_attrs2, rng,
            all_rows=True)
        ctimings = time_cluster(cc, big_inputs, bmin, bmax, packed, attrs, rng)
    if n_over + s_over == 0:
        raise AssertionError("no overflow row was compared: phase 2 of K6/K7 went unchecked")
    cluster_errs = {k: max(big_errs[k], small_errs[k]) for k in big_errs}
    print("[cluster] K3 exact, K6/K7 bitwise against their plain versions")

    # --- phase 3: Cornell render -------------------------------------------------
    with tempfile.TemporaryDirectory() as out_dir:
        exr = os.path.join(out_dir, "cornell_768_16spp.exr")
        torch.cuda.reset_peak_memory_stats(dev)
        reset(ic.LAUNCHES)
        reset(cc.LAUNCHES)
        renderer = cli.run([
            "chiaroscuro_tpu_torch", os.path.join(repo, "scenes", "cornell.rtc"),
            "no-preview", "samples", str(RENDER_SPP), "output", exr,
        ])
        launches = dict(ic.LAUNCHES)
        cluster_in_cornell = dict(cc.LAUNCHES)
        sync()
        peak = torch.cuda.max_memory_allocated(dev)
        exported = read_exr(exr)
    cfg, st = renderer.cfg, renderer.last_stats
    img = renderer.pixels
    print(f"[render] {cfg.xres}x{cfg.yres} k={cfg.k} spp={cfg.samples} "
          f"launches={launches} mean={float(img.mean())} max={float(img.max())}")
    if (cfg.xres, cfg.yres, cfg.k, cfg.samples) != (768, 768, RENDER_K, RENDER_SPP):
        raise AssertionError("scenes/cornell.rtc no longer renders 768x768 at k 6")
    if launches != {"closest": RENDER_SPP * RENDER_K, "any": RENDER_SPP * RENDER_K}:
        raise AssertionError(f"kernel launches {launches} != samples x k")
    if any(cluster_in_cornell.values()):
        raise AssertionError(f"Cornell launched cluster kernels: {cluster_in_cornell}")
    if not (np.isfinite(img).all() and img.mean() > 1e-3 and (img > 1e-3).mean() > 0.5):
        raise AssertionError("render is not finite and non-trivial")
    # The EXR stores HALF floats: 2^-11 relative.
    if not np.allclose(exported, img, rtol=2.0**-10, atol=1e-6):
        raise AssertionError("the exported EXR does not read back as the render")

    small_cfg = ["input", "builtin:cornell_box", "xres", "128", "yres", "128",
                 "samples", "4", "k", "6", "VP", "278", "273", "-800",
                 "LA", "278", "273", "0", "yview", "0.7"]
    imgs = {}
    for platform in ("cuda", "cpu"):
        c = RenderConfig.from_tokens(small_cfg + ["platform", platform])
        s = load_scene(c, dev if platform == "cuda" else torch.device("cpu"))
        imgs[platform] = render_image(s, c).cpu().numpy()
    sync()
    assert_render_close(imgs["cuda"], imgs["cpu"], "cornell 128x128")

    # --- phase 3b: atrium render ---------------------------------------------------
    cam = ["VP", *map(str, ATRIUM_CAMERA["eye"]), "LA", *map(str, ATRIUM_CAMERA["center"]),
           "UP", *map(str, ATRIUM_CAMERA["up"]), "yview", str(ATRIUM_CAMERA["yview"])]
    del big, packed, attrs, waves, big_inputs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        exr = os.path.join(out_dir, "atrium_1280x720.exr")
        torch.cuda.reset_peak_memory_stats(dev)
        reset(ic.LAUNCHES)
        reset(cc.LAUNCHES)
        t0 = time.perf_counter()
        a_renderer = cli.run([
            "chiaroscuro_tpu_torch", os.path.join(repo, "scenes", "cornell.rtc"),
            "no-preview", "input", "synthetic:atrium", "intersector", "auto",
            "xres", str(ATRIUM_RES[0]), "yres", str(ATRIUM_RES[1]), "samples", "1",
            "k", str(ATRIUM_K), "output", exr, *cam,
        ])
        a_total = time.perf_counter() - t0
        a_launches = dict(cc.LAUNCHES)
        dense_in_atrium = dict(ic.LAUNCHES)
        sync()
        a_peak = torch.cuda.max_memory_allocated(dev)
        a_exported = read_exr(exr)
    a_img, a_st, a_cfg = a_renderer.pixels, a_renderer.last_stats, a_renderer.cfg
    # Lit: tests/test_synthetic.py's median of the per-pixel max, taken over
    # 4x4-pixel block means.  At 1 spp most single pixels are legitimately
    # black (NEE occluded, then Russian roulette ends the path: 44% of the
    # pixels of this frame are non-zero in a CPU render, 87% at 4 spp); a
    # block mean is a 16-sample estimate.
    blocks = a_img.reshape(180, 4, 320, 4, 3).mean(axis=(1, 3))
    lit = float(np.median(blocks.max(axis=-1)))
    print(f"[render] atrium {a_cfg.xres}x{a_cfg.yres} k={a_cfg.k} spp={a_cfg.samples}: "
          f"launches={a_launches} dense={dense_in_atrium} mean={float(a_img.mean())} "
          f"median max over 4x4 blocks={lit} (per pixel "
          f"{float(np.median(a_img.max(axis=-1)))}, lit pixels "
          f"{float((a_img.max(axis=-1) > 1e-3).mean()):.3f}) "
          f"compaction={a_renderer.intersectors[0].prefers_compaction}")
    want = {"cull": 2 * ATRIUM_K, "closest_cluster": ATRIUM_K, "any_cluster": ATRIUM_K}
    if a_launches != want or any(dense_in_atrium.values()):
        raise AssertionError(f"atrium launches {a_launches} (dense {dense_in_atrium}) != {want}")
    if not (np.isfinite(a_img).all() and a_img.shape == (720, 1280, 3) and lit > 1e-3):
        raise AssertionError("atrium render is not finite and lit")
    if not np.allclose(a_exported, a_img, rtol=2.0**-10, atol=1e-6):
        raise AssertionError("the exported atrium EXR does not read back as the render")

    s_tokens = ["input", "synthetic:atrium:2200", "xres", "160", "yres", "90",
                "samples", "2", "k", "2", *cam]
    s_imgs = {}
    for platform in ("cuda", "cpu"):
        c = RenderConfig.from_tokens(s_tokens + ["platform", platform])
        s = load_scene(c, dev if platform == "cuda" else torch.device("cpu"))
        pair = cc.make_cluster_intersectors(s, stream=True)
        s_imgs[platform] = render_image(s, c, intersectors=pair).cpu().numpy()
        if platform == "cuda":
            cf, af = pair
            cf.prefers_ray_sort = True       # the full path's spatial sorts
            ys, xs = torch.meshgrid(torch.arange(90, device=dev),
                                    torch.arange(160, device=dev), indexing="ij")
            args = (s, c.vp, c.la, c.up, c.yview, 160, 90, xs.reshape(-1), ys.reshape(-1),
                    0, 2, c.seed, 2, c.background, cf, af)
            plain_order = render_samples(*args, compact=False)
            compacted = render_samples(*args, compact=True)
            sync()
            if not torch.equal(bits(plain_order), bits(compacted)):
                raise AssertionError("compacted atrium render differs from the uncompacted one")
            print("[render] atrium(2_200) 160x90 on the card: compact=True (spatial sorts) "
                  "bitwise equal to compact=False")
    sync()
    assert_render_close(s_imgs["cuda"], s_imgs["cpu"], "atrium(2_200) 160x90",
                        flipped_mean_rel=1e-3)

    # --- phase 4: timings ---------------------------------------------------------
    timings = {}
    with torch.no_grad():
        for name, rows, attrs_, q in (
            ("cornell", c_rows, c_attrs, c_q), ("soup", s_rows, s_attrs, s_q),
        ):
            args = (q["live"], q["o3"], q["d3"])
            sargs = args + (q["tmax"], q["excl"], rows)
            timings[("closest", name)] = time_pair(
                lambda: ic.closest_dense(*args, rows, attrs_),
                lambda: ic.closest_dense_plain(*args, rows, attrs_),
            )
            timings[("any", name)] = time_pair(
                lambda: ic.any_dense(*sargs), lambda: ic.any_dense_plain(*sargs),
            )
    for (kern, name), (k_us, p_us, ks, ps) in timings.items():
        print(f"[timing] {card}: {kern}_dense {name} T="
              f"{36 if name == 'cornell' else SOUP_TRIS} B0={B0}: kernel {k_us:.1f} us "
              f"(turns {ks[0]:.1f}, {ks[1]:.1f}), plain {p_us:.1f} us "
              f"(turns {ps[0]:.1f}, {ps[1]:.1f}) per launch")
    for (kern, name), val in ctimings.items():
        nB0 = ctimings[("rows", name)][0]
        if kern == "rows":
            print(f"[timing] {card}: atrium {name}: B0={val[0]} Le={val[1]}, trip p50 {val[2]} "
                  f"on all rows, {val[3]} on the timed sample")
        elif kern.endswith("all rows"):
            print(f"[timing] {card}: {kern} atrium {name} B0={nB0}: kernel {val:.1f} us per launch")
        else:
            k_us, p_us, ks, ps = val
            rows = f"B0={nB0}" if kern == "cull" else f"sample of {ROW_SAMPLE} rows"
            print(f"[timing] {card}: {kern} atrium {name} {rows}: kernel {k_us:.1f} us "
                  f"(turns {ks[0]:.1f}, {ks[1]:.1f}), plain {p_us:.1f} us "
                  f"(turns {ps[0]:.1f}, {ps[1]:.1f}) per launch")
    ms_per_sample = st["seconds"] * 1e3 / cfg.samples
    print(f"[timing] {card}: cornell render 768x768 k6 {cfg.samples} spp: "
          f"{st['seconds']:.3f} s, {ms_per_sample:.2f} ms/sample, "
          f"{st['useful_rays_per_sec'] / 1e6:.1f} useful Mray/s, "
          f"occupancy {st['occupancy']:.3f}; peak device memory {peak / 2**20:.1f} MiB")
    ph = a_renderer.phase_seconds
    print(f"[timing] {card}: atrium 1280x720 k3 1 spp (CLI, cold): scene {ph['scene']:.2f} s, "
          f"clusters + buffers {ph['intersectors']:.2f} s, render {a_st['seconds'] * 1e3:.1f} ms/frame "
          f"({a_st['useful_rays_per_sec'] / 1e6:.2f} useful Mray/s, occupancy "
          f"{a_st['occupancy']:.3f}), export {ph['export']:.2f} s, CLI total {a_total:.2f} s; "
          f"peak device memory {a_peak / 2**20:.1f} MiB")
    # The same frame again, warm, from the CLI's renderer.
    a_renderer.ray_trace(a_cfg.vp, a_cfg.la, a_cfg.up, a_cfg.yview)
    print(f"[timing] {card}: atrium frame warm: {a_renderer.last_stats['seconds'] * 1e3:.1f} "
          f"ms/frame ({a_renderer.last_stats['useful_rays_per_sec'] / 1e6:.2f} useful Mray/s)")

    def entry(name, route, source, replaces, n, e, us):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": e, "ms": us[0] / 1e3, "plain_ms": us[1] / 1e3}

    kernels = [
        entry("closest_dense", "cuda", "chiaroscuro_tpu_torch/csrc/intersect_dense.cu",
              "chiaroscuro_tpu/ops/intersect_pallas.py:206", launches["closest"], err,
              timings[("closest", "cornell")]),
        entry("any_dense", "cuda", "chiaroscuro_tpu_torch/csrc/intersect_dense.cu",
              "chiaroscuro_tpu/ops/intersect_pallas.py:339", launches["any"], err,
              timings[("any", "cornell")]),
        entry("cull", "triton", "chiaroscuro_tpu_torch/ops/cull_triton.py",
              "chiaroscuro_tpu/ops/cluster_pallas.py:310", a_launches["cull"],
              cluster_errs["cull"], ctimings[("cull", "primary")]),
        entry("closest_cluster", "cuda", "chiaroscuro_tpu_torch/csrc/intersect_cluster.cu",
              "chiaroscuro_tpu/ops/cluster_pallas.py:627", a_launches["closest_cluster"],
              cluster_errs["closest_cluster"], ctimings[("closest_cluster", "primary")]),
        entry("any_cluster", "cuda", "chiaroscuro_tpu_torch/csrc/intersect_cluster.cu",
              "chiaroscuro_tpu/ops/cluster_pallas.py:750", a_launches["any_cluster"],
              cluster_errs["any_cluster"], ctimings[("any_cluster", "shadow")]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
