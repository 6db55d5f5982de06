"""B1/B2 (the threaded-BVH walks) timed on one checkout's port, so that two
checkouts can be compared on one card.

    python chiaroscuro_tpu_torch/tools/bvh_compare.py [--root DIR] [--out FILE]

Imports ``chiaroscuro_tpu_torch`` from ``DIR`` (by default the checkout that
holds this file), so the same inputs and the same measurement time an older
checkout's kernels too.  Run it once for each checkout, in turns (A, B, B,
A) on one machine.  The inputs are ``chip_smoke.py``'s (taken from the
checkout that holds this file): the primary, bounce (sorted by the spatial
key, as the cluster path sorts it) and NEE shadow wavefronts of the
1280x720 ``ATRIUM_CAMERA`` frames of the 481k atrium and
``synthetic:atrium:262144``, and the 481k bounce wavefront in pixel order,
as the BVH path's row interface traces it.  For each it

- holds the kernel bitwise to the plain walk (``accel/bvh.py``), with equal
  per-ray step and leaf-test counts, on ROW_SAMPLE seeded rows;
- times the kernel by CUDA events on the sample and on every row (two
  turns each), and on every row in a seeded random order;
- prints a digest of every row's outputs and counts: equal digests in two
  turns show two checkouts' kernels equal on every row;
- prints the bounds of every row's walks (``chip_smoke.walk_ops``): per
  lane, and per warp (32 consecutive rays, each warp paying its longest
  walk) in wavefront order and in the random order, with the SIMT
  efficiency (per-lane over per-warp operations).

The last line is one JSON object of all of it; ``--out`` also writes it to
a file.  Needs a card: it raises without one.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
SEED = 20261017
ROW_SAMPLE = 256           # seeded rows held to the plain walk
RES = (1280, 720)
MID_TRIS = 262_144


@functools.cache
def smoke_module():
    """``chip_smoke.py`` of the checkout that holds this file, for its
    wavefronts and bounds (it imports the port only inside its
    functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(CHECKOUT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound_us(ops):
    return ops / smoke_module().PEAK_FP32_UNFUSED * 1e6


def bound_text(counts, perm):
    """The per-lane and per-warp bounds of every row's walks, in wavefront
    order and in the order ``perm``: (text, dict)."""
    walk_ops = smoke_module().walk_ops
    lane, warp = walk_ops(*counts)
    _, warp_r = walk_ops(*counts, order=perm)
    d = {"lane_us": bound_us(lane), "warp_us": bound_us(warp), "warp_random_us": bound_us(warp_r),
         "simt": lane / warp, "simt_random": lane / warp_r}
    return (f"bound per lane {d['lane_us']:.1f} us, per warp {d['warp_us']:.1f} us (SIMT "
            f"{d['simt']:.3f}), random order per warp {d['warp_random_us']:.1f} us (SIMT "
            f"{d['simt_random']:.3f})"), d


def loop_us(fn, reps):
    """us a call by CUDA events over reps calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def turns(fn, reps):
    """(mean, [first, second]) us of two timed loops after a warm call."""
    fn()
    torch.cuda.synchronize()
    a, b = loop_us(fn, reps), loop_us(fn, reps)
    return (a + b) / 2, [a, b]


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(bits(t).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def wave_args(wave, pick=None):
    """The (R, 3) rows of a wavefront (and its tmax, exclude ids), of the
    rows ``pick`` of 128 rays where given."""
    o3, d3, tmax, excl = wave[:4]
    if pick is not None:
        o3, d3 = o3[:, pick], d3[:, pick]
        tmax = None if tmax is None else tmax[pick]
        excl = None if excl is None else excl[pick]
    rows_of = smoke_module().rows_of
    args = (rows_of(o3), rows_of(d3))
    if tmax is not None:
        args += (tmax.reshape(-1).contiguous(), excl.reshape(-1).contiguous())
    return args


def measure(bc, bvh_mod, b, wave, rng, label):
    """Hold one wavefront's walk to the plain walk on a sample, then time
    it and bound it: a dict of the results."""
    every = wave_args(wave)
    occlusion = len(every) == 4
    kid = "B2" if occlusion else "B1"
    nB0 = wave[0].shape[1]
    pick = torch.from_numpy(rng.choice(nB0, min(ROW_SAMPLE, nB0), replace=False)).to(
        every[0].device)
    sample = wave_args(wave, pick)

    def kern(args, counts=False):
        return (bc.any_bvh if occlusion else bc.closest_bvh)(b, *args, counts=counts)

    got = kern(sample, True)
    want = (bvh_mod.bvh_any if occlusion else bvh_mod.bvh_closest)(b, *sample, counts=True)
    outs = ("occluded",) if occlusion else ("hit", "t", "tid", "u", "v")
    bad = [f for f, a, w in zip(outs, got[:-1], want[:-1]) if not torch.equal(bits(a), bits(w))]
    bad += [f for f, a, w in zip(("steps", "tests"), got[-1], want[-1]) if not torch.equal(a, w)]
    if bad:
        raise AssertionError(f"{kid} {label}: the kernel differs from the plain walk in {bad}")
    all_out = kern(every, True)
    counts = all_out[-1]
    R = every[0].shape[0]
    perm = torch.from_numpy(rng.permutation(R)).to(every[0].device)
    shuffled = tuple(x[perm] for x in every)
    res = {"rays": R, "digest": digest(all_out[:-1] + tuple(counts)),
           "steps_mean": float(counts[0].float().mean()), "steps_max": int(counts[0].max()),
           "tests_mean": float(counts[1].float().mean()), "tests_max": int(counts[1].max())}
    res["sample_us"], res["sample_turns"] = turns(lambda: kern(sample), 10)
    res["all_us"], res["all_turns"] = turns(lambda: kern(every), 5)
    res["random_us"], res["random_turns"] = turns(lambda: kern(shuffled), 5)
    text, bd = bound_text(counts, perm)
    res.update(bd)
    print(f"[bvh_compare] {kid} {label}: {R} rays, steps mean {res['steps_mean']:.1f} max "
          f"{res['steps_max']}, tests mean {res['tests_mean']:.1f} max {res['tests_max']}; "
          f"bitwise equal to the plain walk with equal counts on {ROW_SAMPLE} rows; kernel "
          f"{res['sample_us']:.1f} us on them, {res['all_us']:.1f} us on all rows (turns "
          f"{res['all_turns'][0]:.1f}, {res['all_turns'][1]:.1f}), {res['random_us']:.1f} us on "
          f"all rows in a random order; {text}; per-lane share "
          f"{100 * bd['lane_us'] / res['all_us']:.1f}%, per-warp share "
          f"{100 * bd['warp_us'] / res['all_us']:.1f}%; digest {res['digest']}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=CHECKOUT,
                    help="the checkout whose chiaroscuro_tpu_torch is timed")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    a = ap.parse_args(argv)
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import chiaroscuro_tpu_torch as port
    from chiaroscuro_tpu_torch.accel import bvh as bvh_mod
    from chiaroscuro_tpu_torch.ops import bvh_cuda as bc
    from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors
    from chiaroscuro_tpu_torch.scene.synthetic import atrium

    if not torch.cuda.is_available():
        raise RuntimeError("bvh_compare times the kernels on a card; none is visible")
    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != root:
        raise RuntimeError(f"imported {port.__file__}, not the port under {root}")
    smoke = smoke_module()
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[bvh_compare] port {port.__file__}; {card}")
    _, info = bc.build()
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[bvh_compare] {line.strip()}")
    res = {"root": root, "card": card, "walks": {}}
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for label, n in (("atrium 481k", 480_000), (f"atrium:{MID_TRIS}", MID_TRIS)):
            scene = build_scene_tensors(atrium(n), device=dev)
            b = bvh_mod.build_bvh(scene)
            waves, _, _ = smoke.atrium_wavefronts(scene, *RES, dev, pixel_bounce=True)
            names = ["primary", "bounce", "shadow"]
            if n == 480_000:
                names.append("bounce, pixel order")
            for w in names:
                key = f"{'B2' if w == 'shadow' else 'B1'} {label} {w}"
                res["walks"][key] = measure(bc, bvh_mod, b, waves[w], rng, f"{label} {w}")
            del scene, b, waves
            torch.cuda.empty_cache()
    line = json.dumps(res)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
