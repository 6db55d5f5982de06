"""K1/K2 (the dense pair) timed on one checkout's port, so that two
checkouts can be compared on one card.

    python chiaroscuro_tpu_torch/tools/dense_compare.py [--root DIR] [--out FILE]

Imports ``chiaroscuro_tpu_torch`` from ``DIR`` (by default the checkout that
holds this file), so the same inputs and the same measurement time an
older checkout's kernels too.  Run it once for each checkout, in turns
(A, B, B, A) on one machine: a card's host and power limit differ between
machines.  On the inputs of ``chip_smoke.py`` (the seeded Cornell and
4,096-triangle soup queries, B0 = 4,608 rows with a third dead, and the
primary, bounce and shadow wavefronts of the Cornell 768x768 and
``synthetic:atrium:4000`` 1280x720 frames as the integrator makes them) it
checks K1 and K2 bitwise against their plain versions and prints for each
(kernel, input):

- ``loop``: us a call over a loop of calls by CUDA events, mean of two
  turns (what ``chip_smoke.py`` reports);
- ``device``: the kernel's own time a launch by torch.profiler, over the
  launches it recorded (``recorded``);
- ``host``: the host's us a call over the same loop, before the
  synchronisation: the wrapper's time to return.  Where it exceeds
  ``device``, the loop measures the host.

Then the Cornell 768x768 x 16 spp x k 6 render through the CLI (ms/sample,
the CLI's first frame and the same renderer again) and the atrium:4000
1280x720 x 1 spp x k 3 frame (ms, cold and warm).  The last line is one
JSON object of all of it; ``--out`` also writes it to a file.  Needs a
card: it raises without one.
"""

from __future__ import annotations

import argparse
import inspect
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
SEED = 20261016            # chip_smoke.py's phase-2 seed
DENSE_ATRIUM_TRIS = 4000   # synthetic:atrium:4000: 4,040 triangles
HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))


def make_queries(rng, lo, hi, n_tris, dev):
    """Seeded rays over a scene's bounds, B0 rows of 128 with a third of
    the rows dead, and shadow-query limits and exclusions."""
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
    attribute rows: ((v0, v1, v2, attrs), lo, hi)."""
    v0 = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(scale=0.08, size=(n, 3)).astype(np.float32)
    v2 = v0 + rng.normal(scale=0.08, size=(n, 3)).astype(np.float32)
    attrs = rng.normal(size=(n, 32)).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (v0, v1, v2, attrs)]
    lo = np.minimum(v0, np.minimum(v1, v2)).min(0)
    hi = np.maximum(v0, np.maximum(v1, v2)).max(0)
    return t, lo, hi


def dense_wavefronts(cfg, scene, make_intersectors, render_samples):
    """The integrator's first two closest-hit queries (primary, first
    bounce) and its first two occlusion queries (the NEE shadow rays from
    the primary's and the bounce's hits) of sample 0 of a frame through the
    dense pair, recorded as the integrator makes them: {name: dict(live,
    o3, d3[, tmax, excl])}."""
    dev = scene.device
    cf, af = make_intersectors(scene, "dense")
    calls = {"closest": [], "any": []}
    cp, ap = cf.planar_fn, af.planar_fn

    def rec_closest(o3, d3, live=None):
        calls["closest"].append(dict(live=live.reshape(-1).clone(), o3=o3.clone(),
                                     d3=d3.clone()))
        return cp(o3, d3, live=live)

    def rec_any(o3, d3, tmax, excl, live=None):
        calls["any"].append(dict(live=live.reshape(-1).clone(), o3=o3.clone(), d3=d3.clone(),
                                 tmax=tmax.contiguous().clone(),
                                 excl=excl.to(torch.int32).contiguous().clone()))
        return ap(o3, d3, tmax, excl, live=live)

    cf.planar_fn, af.planar_fn = rec_closest, rec_any
    ys, xs = torch.meshgrid(torch.arange(cfg.yres, device=dev),
                            torch.arange(cfg.xres, device=dev), indexing="ij")
    with torch.no_grad():
        render_samples(scene, cfg.vp, cfg.la, cfg.up, cfg.yview, cfg.xres, cfg.yres,
                       xs.reshape(-1), ys.reshape(-1), 0, 1, cfg.seed, 2, cfg.background,
                       cf, af)
    return {"primary": calls["closest"][0], "bounce": calls["closest"][1],
            "shadow": calls["any"][0], "bounce shadow": calls["any"][1]}


def cam_tokens(cam):
    return ["VP", *map(str, cam["eye"]), "LA", *map(str, cam["center"]),
            "UP", *map(str, cam["up"]), "yview", str(cam["yview"])]


def loop_us(fn, reps):
    """(us a call by CUDA events, the host's us a call) over reps calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps, host * 1e6 / reps


def device_us(fn, reps):
    """The dense kernel's own time by torch.profiler over reps calls: (us a
    launch over the launches recorded, or None; the launches recorded),
    since the profiler can record fewer than the calls made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == DeviceType.CUDA and "dense" in e.key]
    us = sum(float(getattr(e, "self_device_time_total", 0.0)) for e in events)
    n = sum(int(e.count) for e in events)
    return (us / n if us > 0 and n else None), n


def measure(ic, kind, label, rows, attrs, q):
    """Check one (kernel, input) against the plain version bitwise, then
    time it: {"loop", "turns", "device", "host"} in us and "recorded"."""
    args = (q["live"], q["o3"], q["d3"])
    # An older port's wrappers make no padded table; a newer one's make it
    # once per intersector pair, so it is made here once too.
    table = ()
    if "table" in inspect.signature(ic.closest_dense).parameters:
        table = (ic.pad_table(rows),)
    if kind == "K1":
        def fn():
            return ic.closest_dense(*args, rows, attrs, *table)
        got, want = fn(), ic.closest_dense_plain(*args, rows, attrs)
        same = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b)
                   for a, b in zip(got, want))
    else:
        def fn():
            return ic.any_dense(*args, q["tmax"], q["excl"], rows, *table)
        same = torch.equal(fn(), ic.any_dense_plain(*args, q["tmax"], q["excl"], rows))
    if not same:
        raise AssertionError(f"{kind} on {label}: the kernel differs from its plain version")
    reps = 50 if rows.shape[0] < 512 else 10
    fn()
    torch.cuda.synchronize()
    first = loop_us(fn, reps)
    second = loop_us(fn, reps)
    dev, n_dev = device_us(fn, reps)
    out = {"loop": (first[0] + second[0]) / 2, "turns": [first[0], second[0]],
           "host": (first[1] + second[1]) / 2, "device": dev, "recorded": n_dev}
    dev_text = "not measured" if dev is None else f"{dev:.1f}"
    print(f"[dense_compare] {kind} {label} T={rows.shape[0]} B0={q['o3'].shape[1]}: "
          f"loop {out['loop']:.1f} us (turns {first[0]:.1f}, {second[0]:.1f}), device "
          f"{dev_text} us ({n_dev} of {reps} launches recorded), host {out['host']:.1f} us "
          "a call; bitwise equal to plain")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=CHECKOUT,
                    help="the checkout whose chiaroscuro_tpu_torch is timed")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    from chiaroscuro_tpu_torch import cli
    import chiaroscuro_tpu_torch as port
    from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
    from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.scene.builtin import cornell_box
    from chiaroscuro_tpu_torch.scene.config import RenderConfig
    from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors, load_scene
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA

    if not torch.cuda.is_available():
        raise RuntimeError("dense_compare times the kernels on a card; none is visible")
    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != root:
        raise RuntimeError(f"imported {port.__file__}, not the port under {root}")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[dense_compare] port {port.__file__}; {card}")
    ic.build()
    res = {"root": root, "card": card, "kernels": {}}

    rng = np.random.default_rng(SEED)
    cornell = build_scene_tensors(cornell_box(), device=dev)
    c_rows = ic._prep_tris(cornell.tri_v0, cornell.tri_v1, cornell.tri_v2)
    c_attrs = ic._prep_attrs(cornell)
    c_q = make_queries(rng, cornell.world_min.cpu().numpy(),
                       cornell.world_max.cpu().numpy(), cornell.n_tris, dev)
    (sv0, sv1, sv2, s_attrs), s_lo, s_hi = soup(rng, SOUP_TRIS, dev)
    s_rows = ic._prep_tris(sv0, sv1, sv2)
    s_q = make_queries(rng, s_lo, s_hi, SOUP_TRIS, dev)
    with torch.no_grad():
        for label, rows, attrs, q in (("cornell queries", c_rows, c_attrs, c_q),
                                      ("soup queries", s_rows, s_attrs, s_q)):
            for kind in ("K1", "K2"):
                res["kernels"][f"{kind} {label}"] = measure(ic, kind, label, rows, attrs, q)

    cornell_rtc = os.path.join(CHECKOUT, "scenes", "cornell.rtc")
    a4_tokens = ["input", f"synthetic:atrium:{DENSE_ATRIUM_TRIS}", "intersector", "auto",
                 "xres", "1280", "yres", "720", "samples", "1", "k", "3",
                 *cam_tokens(ATRIUM_CAMERA)]
    with torch.no_grad():
        for label, cfg in (("cornell 768x768", RenderConfig.from_rtc(cornell_rtc)),
                           (f"atrium:{DENSE_ATRIUM_TRIS} 1280x720",
                            RenderConfig.from_rtc(cornell_rtc, a4_tokens))):
            sc = load_scene(cfg, dev)
            rows = ic._prep_tris(sc.tri_v0, sc.tri_v1, sc.tri_v2)
            attrs = ic._prep_attrs(sc)
            for w, q in dense_wavefronts(cfg, sc, make_intersectors, render_samples).items():
                kind = "K2" if "tmax" in q else "K1"
                res["kernels"][f"{kind} {label} {w}"] = measure(ic, kind, f"{label} {w}",
                                                               rows, attrs, q)
            del sc

    frames = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for label, tokens, per in (("cornell 768x768 k6 16 spp", ["samples", "16"], 16),
                                   (f"atrium:{DENSE_ATRIUM_TRIS} 1280x720 k3 1 spp",
                                    a4_tokens, 1)):
            r = cli.run(["chiaroscuro_tpu_torch", cornell_rtc, "no-preview", *tokens,
                         "output", os.path.join(out_dir, "frame.exr")])
            cold = r.last_stats["seconds"] * 1e3 / per
            warm = []
            for _ in range(3):
                r.ray_trace(r.cfg.vp, r.cfg.la, r.cfg.up, r.cfg.yview)
                warm.append(r.last_stats["seconds"] * 1e3 / per)
            unit = "ms/sample" if per > 1 else "ms/frame"
            frames[label] = {"unit": unit, "cold": cold, "warm": warm}
            print(f"[dense_compare] {label}: {unit} cold {cold:.2f}, warm "
                  + ", ".join(f"{x:.2f}" for x in warm))
            del r
    res["frames"] = frames
    line = json.dumps(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
