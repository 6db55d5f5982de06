"""K3b (``csrc/cull_beam.cu``) against variants of its own design, built
side by side and timed in turns on one card.

    python -m chiaroscuro_tpu_torch.tools.beam_compare

Each variant is the checkout's ``csrc/cull_beam.cu`` and
``csrc/row_select.cuh`` with a few lines replaced (VARIANTS), built by
``nvcc`` with the port's flags into a temporary directory.  On the primary,
bounce and shadow wavefronts of ``chip_smoke.py``'s 1280x720
``ATRIUM_CAMERA`` frames of the 481k and 3M atriums it holds every variant's
lists bitwise to the two-step cull's (``chip_smoke.beam_two_step``: the
sweep kernel, then the stable sort; the diagnostic variants, whose lists
are not the cull's, are only timed) and times all of them and the two-step
by CUDA events, in turns (the given order, then reversed).  Prints the
card, each variant's registers, and one line a wavefront; the last line is
one JSON object of the times (us).  Needs a card: it raises without one.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(CHECKOUT, "chiaroscuro_tpu_torch", "csrc")
SOURCES = ("cull_beam.cu", "row_select.cuh")

# name: ([(text, replacement)], the lists are the cull's).
VARIANTS = {
    "as built": ([], True),
    "512 threads only": ([("const bool narrow = 4 * (bytes + 1024) <= per_sm;",
                           "const bool narrow = false;")], True),
    "no stop at fit": ([("th.below + in_bin <= cap || th.shift == 0) break;",
                         "th.shift == 0) break;"),
                        ("th.all = in_bin == r + 1 || th.below + in_bin <= cap;",
                         "th.all = in_bin == r + 1;")], True),
    "bitonic only": ([("if (n <= kRankMax) {", "if (false) {")], True),
    # Diagnostics: the sweep and the tallies alone; the lists unsorted.
    "sweep only": ([(re.compile(r"  row_select::write_lists<kThreads>\(.*?\);", re.S),
                     "  if (t == 0) meta[2 * (size_t)row] = s->count;")], False),
    "no sort": ([("    bitonic_sort<kThreads>(pairs, n);\n", "")], False),
}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(CHECKOUT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(name, edits, tmp):
    """Build one variant; returns (its ctypes library, ptxas's register lines)."""
    from chiaroscuro_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc

    d = os.path.join(tmp, re.sub(r"\W", "_", name))
    os.makedirs(d)
    for f in SOURCES:
        shutil.copy(os.path.join(CSRC, f), d)
    for old, new in edits:
        for f in SOURCES:
            path = os.path.join(d, f)
            with open(path) as fh:
                text = fh.read()
            edited = (old.sub(lambda m: new, text, count=1) if isinstance(old, re.Pattern)
                      else text.replace(old, new, 1))
            if edited != text:
                with open(path, "w") as fh:
                    fh.write(edited)
                break
        else:
            raise RuntimeError(f"variant {name!r}: no line to replace: {str(old)[:60]}")
    so = os.path.join(d, "libcull_beam.so")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", so, os.path.join(d, SOURCES[0])],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name!r} did not build:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.cull_beam_launch.argtypes, lib.cull_beam_launch.restype = [vp] * 5 + [ci] * 3 + [vp] * 5, ci
    return lib, [ln.split(":", 1)[1].strip() for ln in proc.stderr.splitlines() if "Used" in ln]


def launch(lib, o3, d3, bmin, bmax, Le, tmax):
    """One launch of a variant's cull_beam_launch: (meta, ids, nears, cutoff)."""
    B0, K = o3.shape[1], bmin.shape[0]
    out = (torch.zeros((B0, 2), dtype=torch.int32, device=o3.device),
           torch.empty((B0, Le), dtype=torch.int32, device=o3.device),
           torch.empty((B0, Le), dtype=torch.float32, device=o3.device),
           torch.empty((B0, 1), dtype=torch.float32, device=o3.device))
    err = lib.cull_beam_launch(o3.data_ptr(), d3.data_ptr(),
                               None if tmax is None else tmax.data_ptr(), bmin.data_ptr(),
                               bmax.data_ptr(), B0, K, Le, *(x.data_ptr() for x in out),
                               torch.cuda.current_stream(o3.device).cuda_stream)
    if err:
        raise RuntimeError(f"cull_beam_launch failed: CUDA error {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("beam_compare needs an NVIDIA GPU")
    sys.path.insert(0, CHECKOUT)
    from chiaroscuro_tpu_torch.accel.clusters import build_clusters
    from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
    from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors
    from chiaroscuro_tpu_torch.scene.synthetic import atrium

    smoke = _smoke()
    dev = torch.device("cuda", 0)
    print(smoke.card_line())
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (edits, _) in VARIANTS.items():
            libs[name], regs = build(name, edits, tmp)
            print(f"[beam_compare] {name}: " + "; ".join(regs))
        report = {}
        for tris in (480_000, smoke.BIG3M_TRIS):
            scene = build_scene_tensors(atrium(tris), device=dev)
            ca = build_clusters(*(x.cpu().numpy() for x in (scene.tri_v0, scene.tri_v1,
                                                            scene.tri_v2)))
            bmin, bmax = (torch.from_numpy(b).to(dev) for b in (ca.bbox_min, ca.bbox_max))
            with torch.no_grad():
                waves = smoke.atrium_wavefronts(scene, *smoke.ATRIUM_RES, dev, clusters=ca)[0]
            Le = min(cc.DEFAULT_LMAX, ca.K)
            for w in ("primary", "bounce", "shadow"):
                o3, d3, tmax = waves[w][:3]
                want = smoke.beam_two_step(cc, o3, d3, bmin, bmax, Le, tmax)[2]
                fns = {}
                for name, lib in libs.items():
                    got = launch(lib, o3, d3, bmin, bmax, Le, tmax)
                    torch.cuda.synchronize()
                    if VARIANTS[name][1] and not all(
                            torch.equal(smoke.bits(a), smoke.bits(b)) for a, b in zip(got, want)):
                        raise AssertionError(f"{name}: lists differ from the two-step's on "
                                             f"{tris} {w}")
                    fns[name] = lambda lib=lib: launch(lib, o3, d3, bmin, bmax, Le, tmax)
                fns["two-step"] = lambda: smoke.beam_two_step(cc, o3, d3, bmin, bmax, Le, tmax)
                t = smoke.time_turns(fns, {n: 10 for n in fns})
                key = f"{tris} {w}"
                report[key] = {n: v[0] for n, v in t.items()}
                print(f"[beam_compare] {key} (K={ca.K}, overflow rows "
                      f"{int(want[0][:, 1].sum())}): " + "; ".join(
                          f"{n} {v[0]:.1f} us ({v[1][0]:.1f}, {v[1][1]:.1f})"
                          for n, v in t.items()))
            del scene, waves, bmin, bmax
            torch.cuda.empty_cache()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
