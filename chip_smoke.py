#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``chiaroscuro_tpu_torch`` on the card in these phases; any failure
raises, exits non-zero and prints no result line.

1. Device and build: the card's name and power limit (nvidia-smi), torch's
   device name and count.  The CUDA sources (``csrc/intersect_dense.cu``
   K1/K2, ``csrc/intersect_cluster.cu`` K4-K7, ``csrc/cull_rowhit.cu`` X1,
   ``csrc/dma_min.cu`` X2) build in parallel, one nvcc each, while the
   Triton cull K3 (``ops/cull_triton.py``) compiles; build seconds,
   registers, shared memory and spills are printed.
2. Dense kernels vs plain: K1/K2 against their plain torch versions at
   Cornell (T = 36) and a seeded random soup (T = 4,096), B0 = 4,608 rows
   (one 768x768 wavefront) with a third of the rows dead: bitwise equal.
2b. Streaming cluster kernels vs plain at the full atrium (481,208
   triangles, K = 3,760 clusters of 128, streaming): the primary wavefront
   of the 1280x720 ``ATRIUM_CAMERA`` frame (B0 = 7,200), one cosine-sampled
   bounce wavefront from its hits and the NEE shadow wavefront, each sorted
   as the integrator sorts it on this path.  K3 must equal its plain version
   exactly on every row (closest and shadow queries); K6/K7 must be bitwise
   equal to theirs on a seeded sample of rows plus every row that overflowed
   its list.  X1 (the row-hit cull of the tool path) on every row of the
   primary wavefront, without tmax and with tmax = each ray's closest hit:
   exactly equal to its plain version and, sliced to K, to K3's hit mask;
   timed beside K3's sweep and the whole K3 cull on the same rays.
2c. Resident cluster kernels at Sponza scale (``synthetic:atrium:262144``,
   261,396 triangles, K = 2,043, resident by the JAX rule): the same four
   wavefronts of its 1280x720 frame.  K3 exact on every row; K4/K5 bitwise
   equal to the plain versions on a seeded row sample plus every overflow
   row, and bitwise equal to K6/K7 on every row; per-row visit counts.  The
   same checks (every row) on atrium(2_200, seed=5) at M = 32 with 32-wide
   lists, most of whose rows overflow.  X1 as in 2b on every row of the NEE
   shadow wavefront (with its tmax).
3. Cornell render: the CLI's batch render of ``scenes/cornell.rtc`` at its
   768x768 and k 6, at RENDER_SPP samples, into an EXR in a temporary
   directory that is read back; finite, non-trivial, one K1 and one K2
   launch per sample x bounce.  A 128x128, 4 spp, k 6 render on the card is
   held against the same render on the CPU (the plain versions).
3b. Atrium render: the CLI renders ``synthetic:atrium`` (481k, streaming) at
   1280x720, 1 spp, k 3 with ``intersector auto`` and the ATRIUM_CAMERA view
   into an EXR that is read back: finite and lit (median over 4x4-pixel
   block means of the per-pixel max > 1e-3), and route ``stream`` (2 K3, 1
   K6 and 1 K7 launch per sample x bounce, no resident or dense launch).
   Then atrium(2_200) at 160x90, 2 spp, k 2 through ``intersector
   cluster`` (resident by the rule, K4/K5) and again with ``stream=True``
   (K6/K7) on the card, each held against the CPU render, and the card's
   compacted render (spatial sort forced on) must be bitwise equal to its
   uncompacted one.  Each atrium CLI render is followed by its set-up
   seconds apart from its render, cold and warm ms per frame, useful Mray/s
   and peak device memory (with what was already held when it began: each
   earlier phase lets its scenes go first), and is then let go.
3c. Mid-size renders through ``intersector auto``: ``synthetic:atrium:262144``
   at 1280x720, 1 spp, k 3 (route ``resident``: 6 K3, 3 K4, 3 K5, no K6/K7
   and no dense launch; compaction on) and ``synthetic:atrium:19000`` at
   1024x1024, 1 spp, k 3 (the JAX bench's nanosuit shape; K = 148, no
   compaction), each with a torch.profiler breakdown of one warm frame.
4. Timings (CUDA events, with the card's name and power limit): every
   kernel vs its plain version in us per launch, K4/K5 beside K6/K7 on the
   same lists with visits per launch, and each kernel's bound on the rows
   it was timed on (K4-K7: the 256-row sample and every row).
5. Gradients (``render_samples`` + ``backward``, the intersectors rebuilt on
   the parameter-substituted scene): (i) the card's value and gradients of
   the mean image w.r.t. kd, ke (and tri_v0 on Cornell, tex_data on the
   atrium) against the CPU's, on Cornell 64x64 x 4 spp x k 3 (K1) and
   atrium(2_200) 64x36 x 2 spp x k 2 through K4 and through K6;
   (ii) full width: fwd+bwd w.r.t. (kd, ke) on the 262k atrium at
   1280x720 x 1 spp x k 3 with ``checkpoint=True`` — finite, the lights'
   ke gradients non-zero; (iii) Cornell 512x512 x 16 spp x k 3 fwd+bwd
   through K1 (the JAX bench's 500 spp cut to 16).  ms and peak device
   memory are printed, and torch.profiler breakdowns of one 262k fwd+bwd and
   of a 2-spp Cornell 512x512 fwd+bwd.
6. The tool path: ``tools/cull_experiments.main()`` (the cull shootout on
   ``synthetic:atrium:19000`` at 1024x1024: K3, the dot-reduce and
   scan-free formulations and X1, their masks and lists checked against
   each other, and X1 against its plain version at KB = 256, padded
   columns included) and ``tools/dma_min.main()``, with the tools' launch counts
   set to 0 before and read after; X2 bitwise equal to its plain version
   at trip 0, 5, 16 and 19, and timed beside it and ``big[:trip*M].sum(0)``.

The line before the last is a JSON object of the kernels: for each, the
launches of its path (K1-K7: the main-path CLI runs, counts set to 0 before
each run and read after it, summed over the runs; X1/X2: phase 6), its
largest |kernel - plain|, its time and
its plain version's on the stated inputs, and the bound: the larger of the
FP32 operations those inputs need (visits counted per row; occlusion lanes
tested only up to their first blocker) over the card's unfused FP32 rate and the bytes read and written once over its memory rate.
The last line is ``{"ok": true, "device": {...}}``.
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
MID_TRIS = 262_144         # synthetic:atrium:262144, resident by the JAX rule
NANO_TRIS = 19_000         # synthetic:atrium:19000, the nanosuit scale
ROW_SAMPLE = 256           # seeded rows for the plain visit comparisons
VISIT_ROWS = 512           # rows per step of the occlusion bound's replay
SMALL_LMAX = 32            # lists short enough that most atrium(2_200) rows overflow
PIXEL_ORDER_LMAX = 512     # list width for the pixel-order bounce block

# Bounds (H100 SXM peak rates).  With
# -fmad=false every add and multiply is its own instruction, so the FP32
# rate is half the 67 TFLOP/s that counts a fused multiply-add as two.
PEAK_FP32_UNFUSED = 33.5e12    # FP32 operations/s
PEAK_BYTES = 3.35e12           # device memory bytes/s
# FP32 operations of one Moller-Trumbore test (csrc/mt_core.cuh mt_hit):
# p 9, a 5, |a| test 2, f 2, s 3, u 6, q 9, v 6, t 6, acceptance 6.
MT_OPS = 54
# FP32 operations of one (lane, box) slab test (ops/cull_triton.py): per
# axis 2 sub, 2 mul, min, max (18); near/far across axes 4; hit 3; tmax 1;
# max(near, 0), select, min-reduce 3.
CULL_OPS = 29
# FP32 operations of one (lane, box) row-hit test of X1
# (csrc/cull_rowhit.cu): per axis 2 sub, 2 mul, min, max (18); near/far
# across axes 4; hit 3; the row's any 1.  With tmax, 2 more.
X1_OPS = 26

KERNEL_IDS = {"closest_dense": "K1", "any_dense": "K2", "cull": "K3",
              "closest_resident": "K4", "any_resident": "K5",
              "closest_cluster": "K6", "any_cluster": "K7", "cull_rowhit": "X1",
              "dma_min": "X2"}


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


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time for ``ops`` FP32 operations and
    ``nbytes`` bytes moved once."""
    t_ops, t_bytes = ops / PEAK_FP32_UNFUSED, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


def dense_bounds(ic, tri_rows, q):
    """Bounds of K1/K2 on the phase-2 queries: MT_OPS per (live lane,
    triangle) test for K1; for K2 the tests up to each live lane's first
    blocker in id order (it stops there).  Bytes: rays, limits, the
    triangle rows and the attribute rows of the distinct hit triangles
    read once, the outputs written once."""
    T = tri_rows.shape[0]
    live = q["live"].bool()[:, None].expand(B0, 128).reshape(-1)
    R = B0 * 128
    n_live = int(live.sum())
    t, tid, *_ = ic.closest_dense(q["live"], q["o3"], q["d3"], tri_rows,
                                  torch.zeros((T, ic.ATTR_K), device=tri_rows.device))
    n_hit_tris = int(torch.unique(tid[t < ic.BIG]).numel())
    k1 = bound(MT_OPS * T * n_live, R * 24 + B0 * 4 + T * 36 + n_hit_tris * 128 + R * 144)
    # First blocker per lane, triangle by triangle (T is small here).
    o = tuple(q["o3"][a].reshape(1, -1) for a in range(3))
    d = tuple(q["d3"][a].reshape(1, -1) for a in range(3))
    first = torch.full((R,), T, dtype=torch.int64, device=tri_rows.device)
    tm, ex = q["tmax"].reshape(-1), q["excl"].reshape(-1)
    for base in range(0, T, 512):
        tri = tri_rows[base:base + 512]
        cols = tuple(tri[:, c:c + 1] for c in range(9))
        ok, tt, _, _ = ic._mt_core(o, d, cols[0:3], cols[3:6], cols[6:9])
        ids = torch.arange(base, base + tri.shape[0], device=tri.device)[:, None]
        blk = ok & (tt < tm[None]) & (ids != ex[None])
        idx = torch.where(blk, ids, T).amin(dim=0)
        first = torch.minimum(first, idx)
    tests = torch.clamp_max(first + 1, T)[live].sum()
    k2 = bound(MT_OPS * int(tests), R * 33 + B0 * 4 + T * 36)
    return k1, k2


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


def time_turns(fns, reps):
    """Microseconds per call of each named fn, CUDA events, in turns: the
    given order, then reversed (plain, kernel, kernel, plain).  Returns
    {name: (mean, (first turn, second turn))}."""
    for fn in fns.values():
        fn()
    sync()
    first = {n: time_us(f, reps[n]) for n, f in fns.items()}
    second = {n: time_us(f, reps[n]) for n, f in reversed(list(fns.items()))}
    return {n: ((first[n] + second[n]) / 2, (first[n], second[n])) for n in fns}


def time_pair(fn_kernel, fn_plain, reps_kernel=50, reps_plain=3):
    """Microseconds per launch, plain/kernel/kernel/plain, CUDA events."""
    t = time_turns({"plain": fn_plain, "kernel": fn_kernel},
                   {"plain": reps_plain, "kernel": reps_kernel})
    return t["kernel"][0], t["plain"][0], t["kernel"][1], t["plain"][1]


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


def reset(*counts):
    for c in counts:
        for key in c:
            c[key] = 0


def cam_tokens(cam):
    return ["VP", *map(str, cam["eye"]), "LA", *map(str, cam["center"]),
            "UP", *map(str, cam["up"]), "yview", str(cam["yview"])]


# ---------------------------------------------------------------------------
# Phase 2b/2c helpers: the atrium's wavefronts and the cluster comparisons.
# ---------------------------------------------------------------------------


def atrium_wavefronts(scene, xres, yres, dev):
    """The frame's primary wavefront in pixel order, the first bounce from
    its hits (cosine-sampled with the port's samplers, sorted by the
    integrator's spatial key as the cluster path sorts it, dead lanes
    parked; and a block of ROW_SAMPLE rows of it in pixel order) and the NEE
    shadow wavefront from the same hits (sorted by light and cell as
    ``_sorted_any`` sorts it).  Returns {name: (o3, d3,
    tmax or None, excl or None)}, the primary hit share and the primary
    closest-hit distances (B0, 128) (BIG where a ray missed)."""
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
    # sweep measured) they overflow and the visits' phase 2 runs at full
    # scale.
    blk = slice(max(0, B[0] // 2 - ROW_SAMPLE // 2), B[0] // 2 + ROW_SAMPLE // 2)
    waves = {
        "primary": (o3, d3, None, None),
        "bounce": (planar(sm[0:3]), planar(sm[3:6]), None, None),
        "bounce in pixel order": (origin[:, blk].contiguous(), bdir[:, blk].contiguous(),
                                  None, None, PIXEL_ORDER_LMAX),
        "shadow": (planar(ss[0:3]), planar(ss[3:6]), ss[6].reshape(B).contiguous(),
                   ss[7].view(torch.int32).reshape(B).contiguous()),
    }
    return waves, float(hit.float().mean()), res.t.contiguous()


def take_rows(x, rows):
    return x[..., rows, :] if x.dim() == 3 else x[rows]


def visit_kernels(cc, routes, closest):
    """The visit kernels' names for the routes, closest or any."""
    return [cc.ROUTES[r][0 if closest else 1] for r in routes]


def run_visit(cc, kernel, lists, o3, d3, tmax, excl, packed, attrs, visits=None):
    fn = getattr(cc, kernel)
    if tmax is None:
        return fn(*lists, o3, d3, packed, attrs, visits=visits)
    return fn(*lists, o3, d3, tmax, excl, packed, visits=visits)


def compare_cluster(cc, name, waves, bmin, bmax, Le, packed, attrs, rng, all_rows,
                    routes):
    """K3 exact on every row; each route's visit kernels (K4/K5 resident,
    K6/K7 stream) bitwise equal to the plain versions on a row sample (every
    row when ``all_rows``; else ROW_SAMPLE seeded rows plus every overflow
    row), and with both routes K4 vs K6 and K5 vs K7 bitwise on every row.
    Returns the largest |kernel - plain| per kernel, the compared inputs for
    the timings, and the number of overflow rows compared."""
    errs = {"cull": 0.0, **{k: 0.0 for r in routes for k in cc.ROUTES[r]}}
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
        closest = tmax is None
        kernels = visit_kernels(cc, routes, closest)
        outs = {k: run_visit(cc, k, lists, o3, d3, tmax, excl, packed, attrs) for k in kernels}
        if closest:
            want = cc.closest_cluster_plain(*sub, so3, sd3, packed, attrs)
            fields = ("t", "id", "u", "v", "attrs")
        else:
            want = (cc.any_cluster_plain(*sub, so3, sd3, tmax[rows].contiguous(),
                                         excl[rows].contiguous(), packed),)
            fields = ("occluded",)
        sync()
        bad = []
        for k, got in outs.items():
            got = got if closest else (got,)
            for f, a, b in zip(fields, got, want):
                a = take_rows(a, rows)
                if not torch.equal(bits(a), bits(b)):
                    bad.append(f"{KERNEL_IDS[k]} {f} vs plain")
                errs[k] = max(errs[k], max_err(a.float(), b.float()))
        if len(kernels) == 2:
            a_out, b_out = (o if closest else (o,) for o in outs.values())
            for f, a, b in zip(fields, a_out, b_out):
                if not torch.equal(bits(a), bits(b)):
                    bad.append(f"{f}: {KERNEL_IDS[kernels[0]]} vs {KERNEL_IDS[kernels[1]]}")
        first = outs[kernels[0]]
        share = float((first[0] < cc.BIG).float().mean()) if closest else float(first.float().mean())
        trip = meta[:, 0].float()
        vs = (f"; {KERNEL_IDS[kernels[0]]} vs {KERNEL_IDS[kernels[1]]} on all {nB0} rows"
              if len(kernels) == 2 else "")
        print(f"[cluster] {name}/{wname}: B0={nB0} Le={wle} trip p50={float(trip.median())} "
              f"max={int(meta[:, 0].max())} overflow share={float(meta[:, 1].float().mean()):.5f} "
              f"({overflow.numel()} rows); {'/'.join(KERNEL_IDS[k] for k in kernels)} vs plain on "
              f"{rows.numel()} rows ({int(meta[rows, 1].sum())} overflow){vs}: "
              f"{'hit' if closest else 'occluded'} share {share:.4f}, mismatched={bad or 'none'}")
        if bad:
            raise AssertionError(f"{name}/{wname}: {bad}")
        inputs[wname] = (o3, d3, tmax, excl, lists, wle)
    ids = "/".join(KERNEL_IDS[k] for r in routes for k in cc.ROUTES[r])
    print(f"[cluster] {name}: K3 equals plain on every row; {ids} bitwise on the samples "
          f"({n_overflow_sampled} overflow rows among them)")
    return errs, inputs, n_overflow_sampled


def open_lane_tests(cc, lists, o3, d3, tmax, excl, packed, visits, occ):
    """(lane, triangle) tests an occlusion launch needs: each row visits
    the clusters its ``visits`` count covers (phase 1's listed ones, then
    phase 2's identity-order sweep; phase 1 ends early only where phase 2
    makes no visit, since the cutoff is at least every listed near), and
    each lane tests only up to and including its first blocker in that
    order (K5/K7 stop there).  The lanes this finds occluded must be
    ``occ``, the kernel's result, or the visit order is not the kernel's."""
    meta, ids = lists[0], lists[1]
    K, M = packed.shape[0], packed.shape[2]
    Le = ids.shape[1]
    dev = o3.device
    n = visits.long()
    n1 = torch.minimum(n, meta[:, 0].long())
    if bool((n - n1 > K).any()):
        raise AssertionError(f"a row visits past the {K}-cluster sweep")
    done = torch.zeros_like(occ)
    tests = torch.zeros((), dtype=torch.int64, device=dev)
    tri = torch.arange(M, device=dev)[None, :, None]
    # Visit j of every row that makes one, VISIT_ROWS rows at a time.
    for j in range(int(n.max()) if n.numel() else 0):
        for rows in torch.nonzero(n > j).reshape(-1).split(VISIT_ROWS):
            listed = j < n1[rows]
            cid = torch.where(listed, ids[rows, min(j, Le - 1)].long(), j - n1[rows])
            blk = packed[cid]                                  # (R, 10, M)
            cols = tuple(blk[:, c, :, None] for c in range(9))  # (R, M, 1)
            oid = blk[:, 9].contiguous().view(torch.int32)[:, :, None]
            o = tuple(o3[a, rows][:, None] for a in range(3))   # (R, 1, 128)
            d = tuple(d3[a, rows][:, None] for a in range(3))
            ok, t, _, _ = cc._mt_core(o, d, cols[0:3], cols[3:6], cols[6:9])
            blocking = ok & (t < tmax[rows][:, None]) & (oid != excl[rows][:, None])
            first = torch.where(blocking, tri, M).amin(1)     # (R, 128)
            was = done[rows]
            tests += torch.where(was, 0, torch.clamp_max(first + 1, M)).sum()
            done[rows] = was | (first < M)
    if not torch.equal(done, occ):
        raise AssertionError("the occlusion bound's visit order does not reproduce the kernel")
    return int(tests)


def visit_bound(lists, o3, tmax, packed, visits, tests, hit_tris):
    """Bound of one visit launch: MT_OPS per (lane, triangle) test these
    inputs need (closest: every lane over the clusters ``visits`` (per row)
    counts; occlusion: :func:`open_lane_tests`); bytes: rays, lists up to
    trip, the distinct cluster blocks (at most the visits), the attribute
    rows of the ``hit_tris`` distinct hit triangles read once, the outputs
    written once."""
    B0_, M = o3.shape[1], packed.shape[2]
    R = B0_ * 128
    n_vis = int(visits.sum())
    nbytes = (R * 24 + B0_ * 12 + int(lists[0][:, 0].sum()) * 8
              + min(packed.shape[0], n_vis) * packed.shape[1] * M * 4)
    if tmax is None:
        nbytes += hit_tris * 128 + R * 144
    else:
        nbytes += R * 9
    return bound(MT_OPS * tests, nbytes)


def time_cluster(cc, inputs, bmin, bmax, packed, attrs, rng, routes):
    """For each wavefront: K3 on every row (against its plain version) and
    each route's visit kernel on ROW_SAMPLE seeded rows against the plain
    version, in turns; the kernels also on every row.  The per-row visit
    counts of each kernel on the sample and on every row, and the bound of
    the sample launch from the per-visit early exit's count (K6/K7's: the
    least the data needs)."""
    timings = {}
    for wname, (o3, d3, tmax, excl, lists, wle) in inputs.items():
        dev = o3.device
        nB0 = o3.shape[1]
        pick = torch.from_numpy(rng.choice(nB0, min(ROW_SAMPLE, nB0), replace=False)).to(dev)
        sub = tuple(x[pick].contiguous() for x in lists)
        so3, sd3 = o3[:, pick].contiguous(), d3[:, pick].contiguous()
        stm = sex = None
        if tmax is not None:
            stm, sex = tmax[pick].contiguous(), excl[pick].contiguous()
        k_us, p_us, ks, ps = time_pair(
            lambda: cc.cull(o3, d3, bmin, bmax, wle, tmax=tmax),
            lambda: cc.cull_plain(o3, d3, bmin, bmax, wle, tmax=tmax),
            reps_kernel=10, reps_plain=1)
        K = bmin.shape[0]
        ops = CULL_OPS * nB0 * 128 * K
        nbytes = nB0 * 128 * (24 + (4 if tmax is not None else 0)) + K * 24 \
            + nB0 * (12 + 8 * wle)
        timings[("cull", wname)] = dict(us=k_us, plain_us=p_us, turns=ks, plain_turns=ps,
                                        bound=bound(ops, nbytes), rows=nB0)
        closest = tmax is None
        kernels = visit_kernels(cc, routes, closest)
        fns = {"plain": (lambda: cc.closest_cluster_plain(*sub, so3, sd3, packed, attrs))
               if closest else
               (lambda: cc.any_cluster_plain(*sub, so3, sd3, stm, sex, packed))}
        for k in kernels:
            fns[k] = (lambda k=k: run_visit(cc, k, sub, so3, sd3, stm, sex, packed, attrs))
        reps = {n: (1 if n == "plain" else 10) for n in fns}
        sample_t = time_turns(fns, reps)
        full_t = time_turns(
            {k: (lambda k=k: run_visit(cc, k, lists, o3, d3, tmax, excl, packed, attrs))
             for k in kernels}, dict.fromkeys(kernels, 10))
        visits = {}
        for k in kernels:
            vs = torch.zeros(so3.shape[1], dtype=torch.int32, device=dev)
            va = torch.zeros(nB0, dtype=torch.int32, device=dev)
            out = run_visit(cc, k, sub, so3, sd3, stm, sex, packed, attrs, visits=vs)
            out_all = run_visit(cc, k, lists, o3, d3, tmax, excl, packed, attrs, visits=va)
            visits[k] = (vs, va, out, out_all)
        least = cc.ROUTES["stream"][0 if closest else 1]
        least = least if least in visits else kernels[0]
        l_vs, l_va, l_out, l_out_all = visits[least]
        bounds = {}
        for rows, (ls, ro3, rd3, rtm, rex, rv, rout) in {
                "sample": (sub, so3, sd3, stm, sex, l_vs, l_out),
                "all": (lists, o3, d3, tmax, excl, l_va, l_out_all)}.items():
            if closest:
                tests = 128 * packed.shape[2] * int(rv.sum())
                hit_tris = int(torch.unique(rout[1][rout[0] < cc.BIG]).numel())
            else:
                tests = open_lane_tests(cc, ls, ro3, rd3, rtm, rex, packed, rv, rout)
                hit_tris = 0
            bounds[rows] = (visit_bound(ls, ro3, rtm, packed, rv, tests, hit_tris), tests)
        for k in kernels:
            vs, va, _, _ = visits[k]
            timings[(k, wname)] = dict(
                us=sample_t[k][0], turns=sample_t[k][1], plain_us=sample_t["plain"][0],
                plain_turns=sample_t["plain"][1], full_us=full_t[k][0], full_turns=full_t[k][1],
                visits_sample=int(vs.sum()), visits_all=int(va.sum()),
                bound=bounds["sample"][0], tests_sample=bounds["sample"][1],
                bound_all=bounds["all"][0], tests_all=bounds["all"][1], rows=nB0)
        timings[("rows", wname)] = (nB0, wle, float(lists[0][:, 0].float().median()),
                                    float(sub[0][:, 0].float().median()))
    return timings


def compare_x1(xc, cc, cull_triton, what, o3, d3, tmax, bmin, bmax, boxes):
    """X1 on every row of a wavefront: exactly equal to its plain version
    (padded columns 1.0 in every row), and ``rowhit[:, :K] > 0`` exactly
    K3's hit mask; then timed in turns beside K3's Triton sweep and the
    whole K3 cull on the same rays.  Returns the timings and the bound."""
    K, KB, nB0 = bmin.shape[0], boxes.shape[0], o3.shape[1]
    inv = cc._safe_inv(d3)
    got = xc.cull_rowhit(o3, d3, boxes, tmax)
    want = xc.cull_rowhit_plain(o3, d3, boxes, tmax)
    k3_hit, _ = cull_triton.rowhit(o3, inv, bmin, bmax, tmax)
    sync()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: X1 differs from its plain version")
    if not torch.equal(got[:, :K] > 0.0, k3_hit):
        raise AssertionError(f"{what}: X1's row hits differ from K3's hit mask")
    if not bool((got[:, K:] == 1.0).all()):
        raise AssertionError(f"{what}: a padded column of X1 is not 1.0")
    Le = min(cc.DEFAULT_LMAX, K)
    t = time_turns({
        "plain": lambda: xc.cull_rowhit_plain(o3, d3, boxes, tmax),
        "x1": lambda: xc.cull_rowhit(o3, d3, boxes, tmax),
        "k3 sweep": lambda: cull_triton.rowhit(o3, inv, bmin, bmax, tmax),
        "k3 cull": lambda: cc.cull(o3, d3, bmin, bmax, Le, tmax=tmax),
    }, {"plain": 1, "x1": 10, "k3 sweep": 10, "k3 cull": 10})
    ops = (X1_OPS + (2 if tmax is not None else 0)) * nB0 * 128 * K
    nbytes = nB0 * 128 * (24 + (4 if tmax is not None else 0)) + KB * 32 + nB0 * KB * 4
    b = bound(ops, nbytes)
    print(f"[x1] {what}: B0={nB0} K={K} KB={KB} row-hit share "
          f"{float(got[:, :K].mean()):.4f}; X1 equals its plain version and K3's hit mask "
          f"exactly on every row")
    return dict(t=t, bound=b, rows=nB0, K=K, err=max_err(got, want))


def print_x1_timings(card, what, x):
    t, (b_ms, b_by) = x["t"], x["bound"]
    parts = ", ".join(f"{n} {m:.1f} us (turns {a:.1f}, {c:.1f})" for n, (m, (a, c)) in t.items())
    print(f"[timing] {card}: X1 cull_rowhit {what} B0={x['rows']} K={x['K']}: {parts}; "
          f"X1 bound {b_ms * 1e3:.1f} us ({b_by}); X1 / K3 sweep "
          f"{t['x1'][0] / t['k3 sweep'][0]:.3f}, X1 / K3 cull {t['x1'][0] / t['k3 cull'][0]:.3f}")


def print_cluster_timings(card, scene_name, ctimings):
    for (kern, wname), val in ctimings.items():
        if kern == "rows":
            print(f"[timing] {card}: {scene_name} {wname}: B0={val[0]} Le={val[1]}, trip p50 "
                  f"{val[2]} on all rows, {val[3]} on the timed sample")
            continue
        kid = KERNEL_IDS[kern]
        b_ms, b_by = val["bound"]
        if kern == "cull":
            print(f"[timing] {card}: {kid} cull {scene_name} {wname} B0={val['rows']}: kernel "
                  f"{val['us']:.1f} us (turns {val['turns'][0]:.1f}, {val['turns'][1]:.1f}), "
                  f"plain {val['plain_us']:.1f} us (turns {val['plain_turns'][0]:.1f}, "
                  f"{val['plain_turns'][1]:.1f}); bound {b_ms * 1e3:.1f} us ({b_by})")
        else:
            a_ms, a_by = val["bound_all"]
            print(f"[timing] {card}: {kid} {kern} {scene_name} {wname}, sample of {ROW_SAMPLE} "
                  f"rows: kernel {val['us']:.1f} us (turns {val['turns'][0]:.1f}, "
                  f"{val['turns'][1]:.1f}), plain {val['plain_us']:.1f} us (turns "
                  f"{val['plain_turns'][0]:.1f}, {val['plain_turns'][1]:.1f}), "
                  f"{val['visits_sample']} visits, bound {b_ms * 1e3:.1f} us ({b_by}, "
                  f"{val['tests_sample']} lane-triangle tests needed); all "
                  f"{val['rows']} rows: {val['full_us']:.1f} us (turns {val['full_turns'][0]:.1f}, "
                  f"{val['full_turns'][1]:.1f}), {val['visits_all']} visits "
                  f"({val['visits_all'] / val['rows']:.1f} per row), bound {a_ms * 1e3:.1f} us "
                  f"({a_by}, {val['tests_all']} lane-triangle tests needed)")


def cli_render(cli, repo, counts, tokens, out_name):
    """One CLI batch render into a temporary EXR; returns (renderer, the
    launches of every kernel during the run, wall seconds, (peak device
    memory, device memory already held when the run began), the EXR read
    back)."""
    from chiaroscuro_tpu_torch.render.image_io import read_exr

    with tempfile.TemporaryDirectory() as out_dir:
        exr = os.path.join(out_dir, out_name)
        sync()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset(*counts)
        t0 = time.perf_counter()
        renderer = cli.run(["chiaroscuro_tpu_torch", os.path.join(repo, "scenes", "cornell.rtc"),
                            "no-preview", *tokens, "output", exr])
        total = time.perf_counter() - t0
        launches = {k: v for c in counts for k, v in c.items()}
        sync()
        peak = torch.cuda.max_memory_allocated()
        exported = read_exr(exr)
    return renderer, launches, total, (peak, held), exported


def mem_text(mem):
    peak, held = mem
    return (f"peak device memory {peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB of it "
            "held before the run began)")


def report_frame(card, what, r, total, mem):
    """The CLI render's phases, cold frame and memory, then the same frame
    again, warm, from the CLI's renderer."""
    ph, rst = r.phase_seconds, r.last_stats
    print(f"[timing] {card}: {what} k3 1 spp (CLI, cold): scene {ph['scene']:.2f} s, "
          f"clusters + buffers {ph['intersectors']:.2f} s, render {rst['seconds'] * 1e3:.1f} "
          f"ms/frame ({rst['useful_rays_per_sec'] / 1e6:.2f} useful Mray/s, occupancy "
          f"{rst['occupancy']:.3f}), export {ph['export']:.2f} s, CLI total {total:.2f} s; "
          f"{mem_text(mem)}")
    r.ray_trace(r.cfg.vp, r.cfg.la, r.cfg.up, r.cfg.yview)
    print(f"[timing] {card}: {what} frame warm: {r.last_stats['seconds'] * 1e3:.1f} "
          f"ms/frame ({r.last_stats['useful_rays_per_sec'] / 1e6:.2f} useful Mray/s)")


def check_atrium_render(renderer, exported, launches, want, what, res):
    img, cfg = renderer.pixels, renderer.cfg
    xres, yres = res
    blocks = img.reshape(yres // 4, 4, xres // 4, 4, 3).mean(axis=(1, 3))
    lit = float(np.median(blocks.max(axis=-1)))
    print(f"[render] {what} {cfg.xres}x{cfg.yres} k={cfg.k} spp={cfg.samples}: "
          f"launches={launches} route={renderer.intersectors[0].route} mean={float(img.mean())} "
          f"median max over 4x4 blocks={lit} (per pixel {float(np.median(img.max(axis=-1)))}, "
          f"lit pixels {float((img.max(axis=-1) > 1e-3).mean()):.3f}) "
          f"compaction={renderer.intersectors[0].prefers_compaction}")
    if {k: launches[k] for k in want} != want or any(
            n for k, n in launches.items() if k not in want):
        raise AssertionError(f"{what} launches {launches} != {want}")
    if not (np.isfinite(img).all() and img.shape == (yres, xres, 3) and lit > 1e-3):
        raise AssertionError(f"{what} render is not finite and lit")
    if not np.allclose(exported, img, rtol=2.0**-10, atol=1e-6):
        raise AssertionError(f"the exported {what} EXR does not read back as the render")


def profile(fn, label, card):
    """torch.profiler over one call of ``fn``: device time by layer (CUDA
    kernel names), busy share of the profiled wall time, and the kernels'
    per-launch times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    layers, per_launch, n_kernels = {}, {}, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        if us <= 0:
            continue
        name = e.key
        n_kernels += e.count
        if "cull_kernel" in name:
            layer = "K3 cull_kernel"
        elif "closest_cluster_kernel<false>" in name:
            layer = "K4 closest_resident"
        elif "any_cluster_kernel<false>" in name:
            layer = "K5 any_resident"
        elif "closest_cluster_kernel<true>" in name:
            layer = "K6 closest_cluster"
        elif "any_cluster_kernel<true>" in name:
            layer = "K7 any_cluster"
        elif "closest_dense_kernel" in name:
            layer = "K1 closest_dense"
        elif "any_dense_kernel" in name:
            layer = "K2 any_dense"
        elif "sort" in name.lower() or "radix" in name.lower():
            layer = "sorts"
        elif "index" in name.lower() or "gather" in name.lower() or "scatter" in name.lower():
            layer = "gathers and scatters"
        else:
            layer = "integrator (elementwise, Threefry, reductions, copies)"
        layers[layer] = layers.get(layer, 0.0) + us
        if layer.startswith("K"):
            n_prev = per_launch.get(layer, (0.0, 0))[1]
            per_launch[layer] = (layers[layer] / (n_prev + e.count), n_prev + e.count)
    busy = sum(layers.values()) / 1e3
    if busy <= 0:
        print(f"[profile] {card}: {label}: torch.profiler recorded no device time: not measured")
        return
    print(f"[profile] {card}: {label}: {wall_ms:.1f} ms profiled wall, {busy:.1f} ms device "
          f"busy (idle {100 * (1 - busy / wall_ms):.1f}%), {n_kernels} device kernels")
    for layer, us in sorted(layers.items(), key=lambda kv: -kv[1]):
        extra = ""
        if layer in per_launch:
            extra = f" ({per_launch[layer][1]} launches, {per_launch[layer][0] / 1e3:.2f} ms each)"
        print(f"[profile]   {layer}: {us / 1e3:.2f} ms ({100 * us / 1e3 / busy:.1f}% of busy){extra}")


def profile_frame(renderer, card):
    """:func:`profile` over one warm frame of a CLI renderer."""
    cfg = renderer.cfg
    profile(lambda: renderer.ray_trace(cfg.vp, cfg.la, cfg.up, cfg.yview),
            f"{cfg.obj_path} {cfg.xres}x{cfg.yres} k={cfg.k} spp={cfg.samples}, one warm frame",
            card)


# ---------------------------------------------------------------------------
# Phase 5: gradients.
# ---------------------------------------------------------------------------


def grad_run(scene, cam, res, spp, depth, fields, pair_of, checkpoint=False, counts=()):
    """Value and gradients of the mean image w.r.t. ``fields``, the
    intersectors rebuilt on the parameter-substituted scene by
    ``pair_of(scene)``.  Returns (loss, {field: grad on the CPU}, launches,
    seconds, (peak device memory, device memory held when the run began) or
    (0, 0))."""
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.scene.scene_arrays import params_from_numpy

    dev = scene.device
    xres, yres = res
    ys, xs = torch.meshgrid(torch.arange(yres, device=dev), torch.arange(xres, device=dev),
                            indexing="ij")
    held = 0
    if dev.type == "cuda":
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    reset(*counts)
    t0 = time.perf_counter()
    params = params_from_numpy({k: getattr(scene, k).cpu().numpy() for k in fields}, dev)
    s = scene.replace(**params)
    cf, af = pair_of(s)
    img = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], xres, yres,
                         xs.reshape(-1), ys.reshape(-1), 0, spp, 0, depth, (0.0, 0.0, 0.0),
                         cf, af, checkpoint=checkpoint)
    loss = img.mean()
    loss.backward()
    grads = {k: v.grad.cpu() for k, v in params.items()}
    seconds = time.perf_counter() - t0
    launches = {k: v for c in counts for k, v in c.items() if v}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return float(loss.detach()), grads, launches, seconds, (peak, held)


def compare_grads(what, card, cpu, rel=1e-3):
    """Card gradients against the CPU's: per field, sum |d| <= rel x sum
    |g_cpu| (a path that an ulp of a CUDA vs CPU transcendental turned moves
    a few entries, as it moves a few pixels of a render), and the loss to
    rtol 1e-4."""
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    print(f"[grad] {what}: loss card {l_card} cpu {l_cpu}")
    ok = abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    for k, ref in g_cpu.items():
        got = g_card[k]
        d = (got.double() - ref.double()).abs()
        l1 = float(d.sum()) / max(float(ref.double().abs().sum()), 1e-30)
        print(f"[grad]   d/d{k}: sum|card-cpu|/sum|cpu|={l1}, max|card-cpu|={float(d.max())} "
              f"(max|cpu|={float(ref.abs().max())}), finite={bool(torch.isfinite(got).all())}")
        ok = ok and l1 <= rel and bool(torch.isfinite(got).all())
    if not ok:
        raise AssertionError(f"{what}: card gradients differ from the CPU's")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from chiaroscuro_tpu_torch import cli
    from chiaroscuro_tpu_torch.accel.clusters import build_clusters
    from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
    from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
    from chiaroscuro_tpu_torch.ops import cull_triton
    from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
    from chiaroscuro_tpu_torch.render.renderer import render_image, render_samples
    from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA, cornell_box
    from chiaroscuro_tpu_torch.scene.config import RenderConfig
    from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors, load_scene
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA, atrium
    from chiaroscuro_tpu_torch.tools import cull_experiments as xc
    from chiaroscuro_tpu_torch.tools import dma_min as dm

    t_start = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    counts = (ic.LAUNCHES, cc.LAUNCHES)
    main_launches = {k: 0 for c in counts for k in c}   # summed over the CLI runs

    def add_launches(launches):
        for k, n in launches.items():
            main_launches[k] += n

    # --- phase 1: device and build ------------------------------------------
    print(f"[device] nvidia-smi: {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {kind} x{count}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(b) for b in (ic.build, cc.build, xc.build, dm.build)]
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
        dense_bound = dense_bounds(ic, c_rows, c_q)
    print("[kernels] K1/K2 equal their plain versions bitwise")
    sync()

    # --- phase 2b: streaming cluster kernels vs plain (481k) -------------------
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
        waves, primary_hits, primary_t = atrium_wavefronts(big, *ATRIUM_RES, dev)
        if waves["primary"][0].shape[1] != 7200 or primary_hits < 0.99:
            raise AssertionError(f"atrium primary wavefront: B0 or hit share {primary_hits} off")
        big_errs, big_inputs, n_over = compare_cluster(
            cc, "atrium 1280x720", waves, bmin, bmax, Le, packed, attrs, rng, all_rows=False,
            routes=("stream",))
        ctimings = time_cluster(cc, big_inputs, bmin, bmax, packed, attrs, rng,
                                routes=("stream",))
        boxes = torch.from_numpy(xc.pack_cull_boxes(ca.bbox_min, ca.bbox_max)).to(dev)
        x1_times = {
            "481k primary": compare_x1(xc, cc, cull_triton, "atrium 481k primary",
                                       *waves["primary"][:3], bmin, bmax, boxes),
            "481k primary, tmax = hit t": compare_x1(
                xc, cc, cull_triton, "atrium 481k primary, tmax = the closest hit's t",
                *waves["primary"][:2], primary_t, bmin, bmax, boxes),
        }
    if n_over == 0:
        raise AssertionError("no overflow row was compared: phase 2 of K6/K7 went unchecked")
    del big, packed, attrs, waves, big_inputs, boxes, primary_t
    torch.cuda.empty_cache()
    print("[cluster] K3 exact, K6/K7 bitwise against their plain versions; X1 exact against "
          "its plain version and K3's hit mask")

    # --- phase 2c: resident cluster kernels (262k) -----------------------------
    t0 = time.perf_counter()
    mid = build_scene_tensors(atrium(MID_TRIS), device=dev)
    sync()
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    mca = build_clusters(*(x.cpu().numpy() for x in (mid.tri_v0, mid.tri_v1, mid.tri_v2)))
    m_packed, m_attrs = cc.derive_buffers(mid, mca)
    m_bmin = torch.from_numpy(mca.bbox_min).to(dev)
    m_bmax = torch.from_numpy(mca.bbox_max).to(dev)
    sync()
    t_clusters = time.perf_counter() - t0
    print(f"[cluster] atrium:{MID_TRIS}: T={mid.n_tris} lights={mid.n_lights} K={mca.K} "
          f"M={mca.M} stream={cc.streams_by_budget(mca.K, mca.M)} (packed "
          f"{mca.K * mca.M * cc.PACK_W * 4 / 2**20:.1f} MiB by the JAX rule, the port's "
          f"(K, 10, M) matrix {m_packed.numel() * 4 / 2**20:.1f} MiB); scene {t_scene:.2f} s, "
          f"clusters + buffers {t_clusters:.2f} s")
    if (mid.n_tris, mca.K) != (261_396, 2_043) or cc.streams_by_budget(mca.K, mca.M):
        raise AssertionError("atrium:262144 is no longer the 261,396-triangle resident scene")
    with torch.no_grad():
        m_waves, primary_hits, _ = atrium_wavefronts(mid, *ATRIUM_RES, dev)
        if primary_hits < 0.99:
            raise AssertionError(f"atrium:{MID_TRIS} primary hit share {primary_hits} off")
        mid_errs, mid_inputs, n_over = compare_cluster(
            cc, f"atrium:{MID_TRIS} 1280x720", m_waves, m_bmin, m_bmax,
            min(cc.DEFAULT_LMAX, mca.K), m_packed, m_attrs, rng, all_rows=False,
            routes=("resident", "stream"))
        small = build_scene_tensors(atrium(2_200, seed=5), device=dev)
        sca = build_clusters(*(x.cpu().numpy() for x in (small.tri_v0, small.tri_v1, small.tri_v2)), 32)
        s_packed, s_attrs2 = cc.derive_buffers(small, sca)
        s_waves, _, _ = atrium_wavefronts(small, 160, 96, dev)
        small_errs, _, s_over = compare_cluster(
            cc, "atrium(2_200) M=32", s_waves, torch.from_numpy(sca.bbox_min).to(dev),
            torch.from_numpy(sca.bbox_max).to(dev), SMALL_LMAX, s_packed, s_attrs2, rng,
            all_rows=True, routes=("resident", "stream"))
        mtimings = time_cluster(cc, mid_inputs, m_bmin, m_bmax, m_packed, m_attrs, rng,
                                routes=("resident", "stream"))
        x1_times["262k shadow"] = compare_x1(
            xc, cc, cull_triton, f"atrium:{MID_TRIS} shadow", *m_waves["shadow"][:3], m_bmin,
            m_bmax, torch.from_numpy(xc.pack_cull_boxes(mca.bbox_min, mca.bbox_max)).to(dev))
    if n_over == 0 or s_over == 0:
        raise AssertionError("no overflow row was compared: phase 2 of K4/K5 went unchecked")
    cluster_errs = {k: max(big_errs.get(k, 0.0), mid_errs.get(k, 0.0), small_errs.get(k, 0.0))
                    for k in ("cull", *cc.ROUTES["resident"], *cc.ROUTES["stream"])}
    # The renders and phase 5 build their own scenes: hold nothing of this
    # phase's on the card while their peak memory is read.
    del mid, m_packed, m_attrs, m_waves, mid_inputs, small, s_packed, s_attrs2, s_waves
    torch.cuda.empty_cache()
    print("[cluster] K3 exact, K4/K5 bitwise against their plain versions and against K6/K7")

    # --- phase 3: Cornell render -------------------------------------------------
    renderer, launches, _, mem, exported = cli_render(
        cli, repo, counts, ["samples", str(RENDER_SPP)], "cornell_768.exr")
    add_launches(launches)
    cfg, st = renderer.cfg, renderer.last_stats
    img = renderer.pixels
    print(f"[render] {cfg.xres}x{cfg.yres} k={cfg.k} spp={cfg.samples} "
          f"launches={launches} mean={float(img.mean())} max={float(img.max())}")
    if (cfg.xres, cfg.yres, cfg.k, cfg.samples) != (768, 768, RENDER_K, RENDER_SPP):
        raise AssertionError("scenes/cornell.rtc no longer renders 768x768 at k 6")
    want = {"closest": RENDER_SPP * RENDER_K, "any": RENDER_SPP * RENDER_K}
    if launches != {**dict.fromkeys(launches, 0), **want}:
        raise AssertionError(f"kernel launches {launches} != samples x k on K1/K2 only")
    if not (np.isfinite(img).all() and img.mean() > 1e-3 and (img > 1e-3).mean() > 0.5):
        raise AssertionError("render is not finite and non-trivial")
    # The EXR stores HALF floats: 2^-11 relative.
    if not np.allclose(exported, img, rtol=2.0**-10, atol=1e-6):
        raise AssertionError("the exported EXR does not read back as the render")
    del renderer

    small_cfg = ["input", "builtin:cornell_box", "xres", "128", "yres", "128",
                 "samples", "4", "k", "6", *cam_tokens(CORNELL_CAMERA)]
    imgs = {}
    for platform in ("cuda", "cpu"):
        c = RenderConfig.from_tokens(small_cfg + ["platform", platform])
        s = load_scene(c, dev if platform == "cuda" else torch.device("cpu"))
        with torch.no_grad():
            imgs[platform] = render_image(s, c).cpu().numpy()
    sync()
    assert_render_close(imgs["cuda"], imgs["cpu"], "cornell 128x128")

    # --- phase 3b: 481k atrium render, atrium(2_200) card vs CPU ---------------
    cam = cam_tokens(ATRIUM_CAMERA)
    a_renderer, a_launches, a_total, a_mem, a_exported = cli_render(
        cli, repo, counts,
        ["input", "synthetic:atrium", "intersector", "auto", "xres", str(ATRIUM_RES[0]),
         "yres", str(ATRIUM_RES[1]), "samples", "1", "k", str(ATRIUM_K), *cam],
        "atrium_1280x720.exr")
    add_launches(a_launches)
    check_atrium_render(a_renderer, a_exported, a_launches,
                        {"cull": 2 * ATRIUM_K, "closest_cluster": ATRIUM_K,
                         "any_cluster": ATRIUM_K}, "atrium", ATRIUM_RES)
    if a_renderer.intersectors[0].route != "stream":
        raise AssertionError("the 481k atrium did not take the streaming route")
    report_frame(card, "atrium 481k 1280x720", a_renderer, a_total, a_mem)
    del a_renderer, a_exported
    torch.cuda.empty_cache()

    s_tokens = ["input", "synthetic:atrium:2200", "xres", "160", "yres", "90",
                "samples", "2", "k", "2", *cam]
    for stream in (None, True):
        s_imgs = {}
        for platform in ("cuda", "cpu"):
            c = RenderConfig.from_tokens(s_tokens + ["platform", platform])
            s = load_scene(c, dev if platform == "cuda" else torch.device("cpu"))
            pair = cc.make_cluster_intersectors(s, stream=stream)
            reset(*counts)
            with torch.no_grad():
                s_imgs[platform] = render_image(s, c, intersectors=pair).cpu().numpy()
            if platform == "cuda":
                used = {k: n for k, n in cc.LAUNCHES.items() if n}
                route = pair[0].route
                if set(used) != {"cull", *cc.ROUTES[route]}:
                    raise AssertionError(f"atrium(2_200) route {route} launched {used}")
                cf, af = pair
                cf.prefers_ray_sort = True       # the full path's spatial sorts
                ys, xs = torch.meshgrid(torch.arange(90, device=dev),
                                        torch.arange(160, device=dev), indexing="ij")
                args = (s, c.vp, c.la, c.up, c.yview, 160, 90, xs.reshape(-1), ys.reshape(-1),
                        0, 2, c.seed, 2, c.background, cf, af)
                with torch.no_grad():
                    plain_order = render_samples(*args, compact=False)
                    compacted = render_samples(*args, compact=True)
                sync()
                if not torch.equal(bits(plain_order), bits(compacted)):
                    raise AssertionError("compacted atrium render differs from the uncompacted one")
                print(f"[render] atrium(2_200) 160x90 on the card, route {route} ({used}): "
                      "compact=True (spatial sorts) bitwise equal to compact=False")
        sync()
        assert_render_close(s_imgs["cuda"], s_imgs["cpu"],
                            f"atrium(2_200) 160x90 route {route}", flipped_mean_rel=1e-3)

    # --- phase 3c: mid-size renders through auto ---------------------------------
    m_renderer, m_launches, m_total, m_mem, m_exported = cli_render(
        cli, repo, counts,
        ["input", f"synthetic:atrium:{MID_TRIS}", "intersector", "auto",
         "xres", str(ATRIUM_RES[0]), "yres", str(ATRIUM_RES[1]), "samples", "1",
         "k", str(ATRIUM_K), *cam], "atrium_262k.exr")
    add_launches(m_launches)
    resident = {"cull": 2 * ATRIUM_K, "closest_resident": ATRIUM_K, "any_resident": ATRIUM_K}
    check_atrium_render(m_renderer, m_exported, m_launches, resident,
                        f"atrium:{MID_TRIS}", ATRIUM_RES)
    if m_renderer.intersectors[0].route != "resident" or \
            not m_renderer.intersectors[0].prefers_compaction:
        raise AssertionError("atrium:262144 did not take the resident route with compaction")
    report_frame(card, f"atrium:{MID_TRIS} 1280x720", m_renderer, m_total, m_mem)
    profile_frame(m_renderer, card)
    del m_renderer, m_exported
    torch.cuda.empty_cache()
    n_renderer, n_launches, n_total, n_mem, n_exported = cli_render(
        cli, repo, counts,
        ["input", f"synthetic:atrium:{NANO_TRIS}", "intersector", "auto", "xres", "1024",
         "yres", "1024", "samples", "1", "k", str(ATRIUM_K), *cam], "atrium_19k.exr")
    add_launches(n_launches)
    check_atrium_render(n_renderer, n_exported, n_launches, resident,
                        f"atrium:{NANO_TRIS}", (1024, 1024))
    if n_renderer.intersectors[0].route != "resident" or \
            n_renderer.intersectors[0].prefers_compaction:
        raise AssertionError("atrium:19000 did not take the resident route without compaction")
    report_frame(card, f"atrium:{NANO_TRIS} 1024x1024", n_renderer, n_total, n_mem)
    profile_frame(n_renderer, card)
    del n_renderer, n_exported
    torch.cuda.empty_cache()

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
    for kid, (b_ms, b_by) in zip(("K1", "K2"), dense_bound):
        print(f"[timing] {card}: {kid} bound on the cornell queries {b_ms * 1e3:.1f} us ({b_by})")
    print_cluster_timings(card, "atrium 481k", ctimings)
    print_cluster_timings(card, f"atrium:{MID_TRIS}", mtimings)
    for what, x in x1_times.items():
        print_x1_timings(card, what, x)
    ms_per_sample = st["seconds"] * 1e3 / cfg.samples
    print(f"[timing] {card}: cornell render 768x768 k6 {cfg.samples} spp: "
          f"{st['seconds']:.3f} s, {ms_per_sample:.2f} ms/sample, "
          f"{st['useful_rays_per_sec'] / 1e6:.1f} useful Mray/s, "
          f"occupancy {st['occupancy']:.3f}; {mem_text(mem)}")

    # --- phase 5: gradients -------------------------------------------------------
    grad_checks = (
        ("cornell 64x64 x 4 spp x k3 (K1)", lambda d: build_scene_tensors(cornell_box(), device=d),
         CORNELL_CAMERA, (64, 64), 4, 3, ("kd", "ke", "tri_v0"), None, "dense"),
        ("atrium(2_200) 64x36 x 2 spp x k2 (K4)",
         lambda d: build_scene_tensors(atrium(2_200, seed=5), device=d),
         ATRIUM_CAMERA, (64, 36), 2, 2, ("kd", "ke", "tex_data"), False, "resident"),
        ("atrium(2_200) 64x36 x 2 spp x k2 (K6)",
         lambda d: build_scene_tensors(atrium(2_200, seed=5), device=d),
         ATRIUM_CAMERA, (64, 36), 2, 2, ("kd", "ke", "tex_data"), True, "stream"),
    )
    for what, make_scene, gcam, res, spp, depth, fields, stream, route in grad_checks:
        out = {}
        for d in (dev, torch.device("cpu")):
            scene = make_scene(d)
            if route == "dense":
                def pair_of(s):
                    return make_intersectors(s, "dense")
            else:
                gca = build_clusters(*(x.cpu().numpy() for x in
                                       (scene.tri_v0, scene.tri_v1, scene.tri_v2)))

                def pair_of(s, gca=gca, stream=stream):
                    pair = cc.make_cluster_intersectors(s, clusters=gca, stream=stream)
                    if pair[0].route != route:
                        raise AssertionError(f"{what}: route {pair[0].route} != {route}")
                    return pair
            loss, grads, launches, seconds, _ = grad_run(
                scene, gcam, res, spp, depth, fields, pair_of, counts=counts)
            out[d.type] = (loss, grads)
            if d.type == "cuda":
                print(f"[grad] {what} on the card: launches {launches}, {seconds:.3f} s")
                want_kernel = {"dense": "closest", "resident": "closest_resident",
                               "stream": "closest_cluster"}[route]
                if not launches.get(want_kernel):
                    raise AssertionError(f"{what}: no {want_kernel} launch in fwd+bwd")
        compare_grads(what, out["cuda"], out["cpu"])

    # (ii) full width: the 262k atrium, fwd+bwd w.r.t. (kd, ke), checkpointed,
    # on a scene built afresh (phase 2c's was let go before the renders).
    mid = build_scene_tensors(atrium(MID_TRIS), device=dev)
    def mid_pair(s):
        return make_intersectors(s, "cluster", clusters=mca)

    for turn in ("first", "second"):
        loss, grads, g_launches, seconds, g_mem = grad_run(
            mid, ATRIUM_CAMERA, ATRIUM_RES, 1, ATRIUM_K, ("kd", "ke"), mid_pair,
            checkpoint=True, counts=counts)
        lights = mid.light_ids.long().cpu()
        lit_ke = float(grads["ke"][lights].abs().sum())
        print(f"[grad] {card}: atrium:{MID_TRIS} 1280x720 x 1 spp x k3 fwd+bwd w.r.t. (kd, ke), "
              f"checkpoint=True, {turn}: {seconds * 1e3:.1f} ms, {mem_text(g_mem)}, "
              f"loss {loss}, launches {g_launches}; "
              f"sum|d/dke| over the lights {lit_ke}, sum|d/dkd| {float(grads['kd'].abs().sum())}")
        finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
        if not (finite and lit_ke > 0 and g_launches.get("closest_resident")
                and g_launches.get("any_resident") and g_launches.get("cull")):
            raise AssertionError("full-width gradients are not finite and lit, or skipped K3/K4/K5")
    profile(lambda: grad_run(mid, ATRIUM_CAMERA, ATRIUM_RES, 1, ATRIUM_K, ("kd", "ke"),
                             mid_pair, checkpoint=True),
            f"atrium:{MID_TRIS} 1280x720 x 1 spp x k3 fwd+bwd, checkpoint=True", card)
    del mid
    torch.cuda.empty_cache()

    # (iii) Cornell 512x512 x 16 spp x k3 fwd+bwd through K1.
    for turn in ("first", "second"):
        loss, grads, g_launches, seconds, g_mem = grad_run(
            cornell, CORNELL_CAMERA, (512, 512), 16, 3, ("kd", "ke"),
            lambda s: make_intersectors(s, "dense"), checkpoint=True, counts=counts)
        print(f"[grad] {card}: cornell 512x512 x 16 spp x k3 fwd+bwd w.r.t. (kd, ke), "
              f"checkpoint=True, {turn}: {seconds * 1e3:.1f} ms, {mem_text(g_mem)}, "
              f"loss {loss}, launches {g_launches}")
        if not (all(bool(torch.isfinite(g).all()) for g in grads.values())
                and float(grads["ke"].abs().sum()) > 0 and g_launches.get("closest")):
            raise AssertionError("Cornell 512x512 gradients are not finite and lit")
    profile(lambda: grad_run(cornell, CORNELL_CAMERA, (512, 512), 2, 3, ("kd", "ke"),
                             lambda s: make_intersectors(s, "dense"), checkpoint=True),
            "cornell 512x512 x 2 spp x k3 fwd+bwd, checkpoint=True", card)

    # --- phase 6: the tool path (X1 in the cull shootout, X2) -------------------
    t0 = time.perf_counter()
    reset(xc.LAUNCHES, dm.LAUNCHES)
    shootout = xc.main()
    x2_out, x2_x = dm.main()
    tool_launches = {**xc.LAUNCHES, **dm.LAUNCHES}
    t_tools = time.perf_counter() - t0
    if shootout["K"] != 148 or shootout["B0"] != 8192:
        raise AssertionError(f"the shootout ran K={shootout['K']}, B0={shootout['B0']}, "
                             "not atrium:19000 at 1024x1024")
    x2_err = 0.0
    for trip in (0, 5, dm.K, dm.K + 3):
        meta = torch.tensor([[trip, 0]], dtype=torch.int32, device=dev)
        got, want = dm.dma_min(meta, x2_x), dm.dma_min_plain(meta, x2_x)
        sync()
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"X2 differs from its plain version at trip {trip}")
        x2_err = max(x2_err, max_err(got, want))
        print(f"[x2] trip {trip}: X2 bitwise equal to its plain version; column sums "
              f"{float(got.min()):.3f}..{float(got.max()):.3f}")
    if not torch.equal(bits(x2_out), bits(dm.dma_min_plain(
            torch.tensor([[dm.K, 0]], dtype=torch.int32, device=dev), x2_x))):
        raise AssertionError("the repro's X2 output differs from its plain version")
    full = torch.tensor([[dm.K, 0]], dtype=torch.int32, device=dev)
    x2_t = time_turns({
        "plain": lambda: dm.dma_min_plain(full, x2_x),
        "x2": lambda: dm.dma_min(full, x2_x),
        "library": lambda: x2_x[:dm.K * dm.M].sum(0),
    }, {"plain": 10, "x2": 100, "library": 100})
    # X2 reads trip's K distinct blocks once and adds trip x M x W values.
    x2_bound = bound(dm.K * dm.M * dm.W, 8 + dm.K * dm.M * dm.W * 4 + dm.W * 4)
    print(f"[tools] launches {tool_launches} in {t_tools:.1f} s")
    print(f"[timing] {card}: X2 dma_min trip {dm.K}: "
          + ", ".join(f"{n} {m:.2f} us (turns {a:.2f}, {c:.2f})" for n, (m, (a, c)) in x2_t.items())
          + f"; bound {x2_bound[0] * 1e3:.3f} us ({x2_bound[1]})")
    # Launches above for comparison and timing do not count: the counts
    # are the tool phase's.

    def entry(name, route, source, replaces, e, ms, plain_ms, bnd, launches=None,
              library_ms=None):
        if launches is None:
            launches = main_launches[name if name not in ("closest_dense", "any_dense")
                                     else name.split("_")[0]]
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}

    def visit_entry(name, replaces, t):
        return entry(name, "cuda", "chiaroscuro_tpu_torch/csrc/intersect_cluster.cu",
                     replaces, cluster_errs[name], t["us"] / 1e3, t["plain_us"] / 1e3, t["bound"])

    ct = timings[("closest", "cornell")]
    at = timings[("any", "cornell")]
    cull_t = ctimings[("cull", "primary")]
    x1_t = x1_times["481k primary"]
    kernels = [
        entry("closest_dense", "cuda", "chiaroscuro_tpu_torch/csrc/intersect_dense.cu",
              "chiaroscuro_tpu/ops/intersect_pallas.py:206", err, ct[0] / 1e3, ct[1] / 1e3,
              dense_bound[0]),
        entry("any_dense", "cuda", "chiaroscuro_tpu_torch/csrc/intersect_dense.cu",
              "chiaroscuro_tpu/ops/intersect_pallas.py:339", err, at[0] / 1e3, at[1] / 1e3,
              dense_bound[1]),
        entry("cull", "triton", "chiaroscuro_tpu_torch/ops/cull_triton.py",
              "chiaroscuro_tpu/ops/cluster_pallas.py:310", cluster_errs["cull"],
              cull_t["us"] / 1e3, cull_t["plain_us"] / 1e3, cull_t["bound"]),
        visit_entry("closest_resident", "chiaroscuro_tpu/ops/cluster_pallas.py:485",
                    mtimings[("closest_resident", "primary")]),
        visit_entry("any_resident", "chiaroscuro_tpu/ops/cluster_pallas.py:550",
                    mtimings[("any_resident", "shadow")]),
        visit_entry("closest_cluster", "chiaroscuro_tpu/ops/cluster_pallas.py:627",
                    ctimings[("closest_cluster", "primary")]),
        visit_entry("any_cluster", "chiaroscuro_tpu/ops/cluster_pallas.py:750",
                    ctimings[("any_cluster", "shadow")]),
        entry("cull_rowhit", "cuda", "chiaroscuro_tpu_torch/csrc/cull_rowhit.cu",
              "tools/tpu_cull_experiments.py:52", max(x["err"] for x in x1_times.values()),
              x1_t["t"]["x1"][0] / 1e3,
              x1_t["t"]["plain"][0] / 1e3, x1_t["bound"],
              launches=tool_launches["cull_rowhit"]),
        entry("dma_min", "cuda", "chiaroscuro_tpu_torch/csrc/dma_min.cu",
              "tools/_tpu_dma_min.py:9", x2_err, x2_t["x2"][0] / 1e3, x2_t["plain"][0] / 1e3,
              x2_bound, launches=tool_launches["dma_min"],
              library_ms=x2_t["library"][0] / 1e3),
    ]
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}")
    print(f"[smoke] main-path launches {main_launches}; tool-path launches {tool_launches}; "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
