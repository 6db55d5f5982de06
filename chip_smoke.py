#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``chiaroscuro_tpu_torch`` on the card in four phases; any failure
raises, exits non-zero and prints no result line.

1. Device: the card's name and power limit (nvidia-smi), torch's device name
   and count; the dense intersection kernels are built from
   ``chiaroscuro_tpu_torch/csrc`` (build seconds and ptxas report printed).
2. Kernels vs plain: K1/K2 against their plain torch versions on the card,
   at Cornell (T = 36) and a seeded random soup (T = 4,096), B0 = 4,608 rows
   (one 768x768 wavefront) with a third of the rows dead.  Every output
   must be bitwise equal.
3. Render: the CLI's batch render of ``scenes/cornell.rtc`` at its full
   768x768 and k 6, 16 spp, into an EXR in a temporary directory that is
   read back; the image must be finite and non-trivial and every sample x
   bounce must have launched each kernel once.  Then a 128x128, 4 spp, k 6
   render on the card is held against the same render on the CPU (the
   plain versions).
4. Timings: K1/K2 vs plain in microseconds per launch (CUDA events), the
   render in ms per sample with useful Mray/s, and peak device memory.

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

import numpy as np
import torch

B0 = 4608                  # rows of 128 lanes in one 768x768 wavefront
SOUP_TRIS = 4096           # the largest scene the dense path serves
RENDER_SPP = 16
RENDER_K = 6


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def sync():
    torch.cuda.synchronize()


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


def time_pair(fn_kernel, fn_plain, reps_kernel=50, reps_plain=3):
    """Microseconds per launch, plain/kernel/kernel/plain, CUDA events."""
    def run(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) * 1e3 / reps

    fn_kernel(), fn_plain()
    sync()
    p1 = run(fn_plain, reps_plain)
    k1 = run(fn_kernel, reps_kernel)
    k2 = run(fn_kernel, reps_kernel)
    p2 = run(fn_plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2), (p1, p2)


def assert_render_close(img, ref, mean_rel=1e-4, outlier_share=0.005):
    """The CPU tests' bound (tests/test_torch_render.py)."""
    mean_abs = float(np.abs(img - ref).mean())
    outside = float((~np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)).mean())
    print(f"[render] card vs cpu 128x128: mean|d|/mean={mean_abs / float(ref.mean())} "
          f"outside rtol 1e-3: {outside}")
    if not (np.isfinite(img).all() and mean_abs <= mean_rel * float(ref.mean())
            and outside <= outlier_share):
        raise AssertionError("card render differs from the CPU render")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from chiaroscuro_tpu_torch import cli
    from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
    from chiaroscuro_tpu_torch.render.image_io import read_exr
    from chiaroscuro_tpu_torch.render.renderer import render_image
    from chiaroscuro_tpu_torch.scene.builtin import cornell_box
    from chiaroscuro_tpu_torch.scene.config import RenderConfig
    from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors, load_scene

    repo = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    # --- phase 1: device and build ------------------------------------------
    print(f"[device] nvidia-smi: {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {kind} x{count}")
    t0 = time.perf_counter()
    _, info = ic.build()
    print(f"[build] {os.path.relpath(info['path'], repo)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")

    # --- phase 2: kernels vs plain --------------------------------------------
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

    # --- phase 3: render --------------------------------------------------------
    with tempfile.TemporaryDirectory() as out_dir:
        exr = os.path.join(out_dir, "cornell_768_16spp.exr")
        torch.cuda.reset_peak_memory_stats(dev)
        for key in ic.LAUNCHES:
            ic.LAUNCHES[key] = 0
        renderer = cli.run([
            "chiaroscuro_tpu_torch", os.path.join(repo, "scenes", "cornell.rtc"),
            "no-preview", "samples", str(RENDER_SPP), "output", exr,
        ])
        launches = dict(ic.LAUNCHES)
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
    if not (np.isfinite(img).all() and img.mean() > 1e-3 and (img > 1e-3).mean() > 0.5):
        raise AssertionError("render is not finite and non-trivial")
    # The EXR stores HALF floats: 2^-11 relative.
    if not np.allclose(exported, img, rtol=2.0**-10, atol=1e-6):
        raise AssertionError("the exported EXR does not read back as the render")

    small = ["input", "builtin:cornell_box", "xres", "128", "yres", "128",
             "samples", "4", "k", "6", "VP", "278", "273", "-800",
             "LA", "278", "273", "0", "yview", "0.7"]
    imgs = {}
    for platform in ("cuda", "cpu"):
        c = RenderConfig.from_tokens(small + ["platform", platform])
        s = load_scene(c, dev if platform == "cuda" else torch.device("cpu"))
        imgs[platform] = render_image(s, c).cpu().numpy()
    sync()
    assert_render_close(imgs["cuda"], imgs["cpu"])

    # --- phase 4: timings ---------------------------------------------------------
    timings = {}
    with torch.no_grad():
        for name, rows, attrs, q in (
            ("cornell", c_rows, c_attrs, c_q), ("soup", s_rows, s_attrs, s_q),
        ):
            args = (q["live"], q["o3"], q["d3"])
            sargs = args + (q["tmax"], q["excl"], rows)
            timings[("closest", name)] = time_pair(
                lambda: ic.closest_dense(*args, rows, attrs),
                lambda: ic.closest_dense_plain(*args, rows, attrs),
            )
            timings[("any", name)] = time_pair(
                lambda: ic.any_dense(*sargs), lambda: ic.any_dense_plain(*sargs),
            )
    for (kern, name), (k_us, p_us, ks, ps) in timings.items():
        print(f"[timing] {card}: {kern}_dense {name} T="
              f"{36 if name == 'cornell' else SOUP_TRIS} B0={B0}: kernel {k_us:.1f} us "
              f"(turns {ks[0]:.1f}, {ks[1]:.1f}), plain {p_us:.1f} us "
              f"(turns {ps[0]:.1f}, {ps[1]:.1f}) per launch")
    ms_per_sample = st["seconds"] * 1e3 / cfg.samples
    print(f"[timing] {card}: render 768x768 k6 {cfg.samples} spp: "
          f"{st['seconds']:.3f} s, {ms_per_sample:.2f} ms/sample, "
          f"{st['useful_rays_per_sec'] / 1e6:.1f} useful Mray/s, "
          f"occupancy {st['occupancy']:.3f}")
    print(f"[timing] {card}: peak device memory {peak / 2**20:.1f} MiB")

    kernels = []
    for kern, line in (("closest", 206), ("any", 339)):
        k_us, p_us = timings[(kern, "cornell")][:2]
        kernels.append({
            "name": f"{kern}_dense",
            "route": "cuda",
            "source": "chiaroscuro_tpu_torch/csrc/intersect_dense.cu",
            "replaces": f"chiaroscuro_tpu/ops/intersect_pallas.py:{line}",
            "launches": launches[kern],
            "max_abs_err": err,
            "ms": k_us / 1e3,
            "plain_ms": p_us / 1e3,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
