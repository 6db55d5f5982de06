"""Rank sweeps: the same tile-sharded work at 1 -> N ranks (torch port of
``chiaroscuro_tpu/parallel/scaling.py``).

- :func:`run_ranks` spawns one process a rank (``torch.multiprocessing``,
  the ``spawn`` start method, since CUDA cannot fork) around a ``file://``
  store in a temporary directory.  Each rank builds its own scene from a
  picklable :class:`RankJob` (a ``RenderConfig``: its ``input`` is a
  ``builtin:`` or ``synthetic:`` name or an OBJ path), as each host of a
  real job loads its own copy, and runs the jobs: a frame
  (``render_frame_sharded``) or a gradient step (``sharded_value_and_grad``
  of :func:`mean_square`).  Results come back through files in that
  directory, with each rank's kernel launches, which are counted per
  process.  A rank's failure re-raises in the caller.
- :func:`measure_scaling` times one frame at each world size: every rank
  renders a warm frame, then the best of ``iters`` frames timed between
  barriers.  Efficiency is wall-clock based, ``eff(N) = t(1) / (N t(N))``
  for a fixed frame (strong scaling, as the reference's OpenMP row loop,
  ``src/rayTracer.cpp:55``).

Run directly for a report: ``python -m chiaroscuro_tpu_torch.parallel.scaling
[scene.rtc] [key value ...]`` (NCCL over the cards present; ``platform cpu``
runs gloo ranks on the CPU).
Ranks that share a device (several ranks on one card, or on the CPU) check
the harness and the sharding's semantics; their "efficiency" is not a
scaling efficiency, and the report says so.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from chiaroscuro_tpu_torch.accel import bvh
from chiaroscuro_tpu_torch.accel.clusters import build_clusters
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.cli import launch_counts
from chiaroscuro_tpu_torch.ops import (bvh_cuda, cluster_cuda, intersect_cuda, scatter_cuda,
                                       threefry_cuda)
from chiaroscuro_tpu_torch.parallel.sharding import (
    _pixel_grid,
    make_tile_mesh,
    render_frame_sharded,
    resolve_device,
    sharded_value_and_grad,
)
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import load_scene

# A rank waiting longer than this in a collective or at a barrier raises.
RANK_TIMEOUT = datetime.timedelta(seconds=600)


@dataclasses.dataclass(frozen=True)
class RankJob:
    """One piece of work for every rank: the frame of ``cfg`` (its input,
    camera, resolution, samples, k, seed, background and intersector), or,
    with ``fields``, the gradient of :func:`mean_square` of that frame with
    respect to those scene fields (``checkpoint`` as in
    ``render_samples``).  ``cluster_size`` is M on the cluster path."""

    cfg: RenderConfig
    cluster_size: int = 128
    fields: Tuple[str, ...] = ()
    checkpoint: bool = False


def mean_square(img: torch.Tensor) -> torch.Tensor:
    """The mean squared radiance of a tile: the MSE against a black target."""
    return (img * img).mean()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _barrier(mesh):
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()


def _clusters(job, scene):
    """The cluster decomposition at the job's M on the cluster path, else
    None (``auto`` clusters at the default M)."""
    if job.cfg.intersector != "cluster":
        return None
    return build_clusters(*(getattr(scene, f).detach().cpu().numpy()
                            for f in ("tri_v0", "tri_v1", "tri_v2")), job.cluster_size)


def _reset_launches():
    for c in (intersect_cuda.LAUNCHES, cluster_cuda.LAUNCHES, bvh_cuda.LAUNCHES,
              scatter_cuda.LAUNCHES, threefry_cuda.LAUNCHES):
        c.update(dict.fromkeys(c, 0))


def _run_job(mesh, job, scene, iters):
    """One job on this rank; returns its results as CPU tensors and numbers."""
    cfg, dev = job.cfg, mesh.device
    clusters = _clusters(job, scene)
    if job.fields:
        run = sharded_value_and_grad(mean_square, job.fields)(mesh, dict(
            eye=cfg.vp, center=cfg.la, up=cfg.up, yview=cfg.yview, xres=cfg.xres,
            yres=cfg.yres, sample_start=0, n_samples=cfg.samples, seed=cfg.seed,
            depth=cfg.k, background=cfg.background, intersector=cfg.intersector,
            clusters=clusters, checkpoint=job.checkpoint))
        px, py = _pixel_grid(cfg.xres, cfg.yres)
        _barrier(mesh)
        _reset_launches()
        t0 = time.perf_counter()
        loss, grads = run(scene, px, py)
        _sync(dev)
        return {"loss": loss.cpu(), "grads": {k: g.cpu() for k, g in grads.items()},
                "launches": launch_counts(), "ms": (time.perf_counter() - t0) * 1e3}

    closest_fn, any_fn = make_intersectors(scene, cfg.intersector, clusters=clusters)

    def frame():
        return render_frame_sharded(
            scene, mesh, cfg.vp, cfg.la, cfg.up, cfg.yview, cfg.xres, cfg.yres,
            cfg.samples, cfg.seed, cfg.k, cfg.background, closest_fn, any_fn)

    _barrier(mesh)
    _reset_launches()
    img = frame()
    _sync(dev)
    launches = launch_counts()
    best = None
    for _ in range(iters):
        _barrier(mesh)
        t0 = time.perf_counter()
        frame()
        _sync(dev)
        _barrier(mesh)
        ms = (time.perf_counter() - t0) * 1e3
        best = ms if best is None else min(best, ms)
    return {"frame": img.cpu(), "launches": launches, "ms": best,
            "route": getattr(closest_fn, "route", None)}


def _rank(rank, world_size, store, backend, device_type, jobs, iters, out_dir):
    """A spawned rank: join the group, run every job, save the results."""
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        # Ranks on the CPU share its cores.  With every core each, 4 ranks'
        # plain BVH walks (many small ops) took 7.0 s a 16x8 frame on an
        # 8-core host, against 0.11 s with the cores split.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, init_method=store, world_size=world_size, rank=rank,
                            timeout=RANK_TIMEOUT)
    try:
        mesh = make_tile_mesh(device=dev)
        scenes, results = {}, []
        for job in jobs:
            key = (job.cfg.obj_path, job.cfg.enable_specular)
            if key not in scenes:
                scenes[key] = load_scene(job.cfg, dev)
            results.append(_run_job(mesh, job, scenes[key], iters))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _build_libraries(device_type):
    """Build every library a rank may load in the caller, once, so that the
    ranks load them instead of each running the compilers."""
    builders = [bvh._native_lib]
    if device_type == "cuda":
        builders += [intersect_cuda.build, cluster_cuda.build_cull, cluster_cuda.build,
                     bvh_cuda.build, scatter_cuda.build, threefry_cuda.build]
    with ThreadPoolExecutor(len(builders)) as pool:
        for f in [pool.submit(b) for b in builders]:
            f.result()


def run_ranks(world_size: int, jobs: Sequence[RankJob], backend: Optional[str] = None,
              device=None, iters: int = 0) -> List[List[dict]]:
    """Spawn ``world_size`` ranks that each run every job; returns, per
    rank, one result a job.  A frame job gives ``frame`` (the gathered
    frame, on every rank), ``launches`` (this rank's kernel launches in
    that frame), ``ms`` (the best of ``iters`` timed frames, None at 0) and
    ``route``; a gradient job gives ``loss``, ``grads``, ``launches`` and
    ``ms``.

    ``device`` is the card (the default; rank r takes card r modulo the
    cards present) or ``"cpu"``.  ``backend`` defaults to NCCL on the card
    and gloo on the CPU; NCCL takes one card a rank, so ranks sharing a card
    need ``backend="gloo"``."""
    device_type = resolve_device(device).type
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one card a rank: {world_size} ranks on "
                         f"{torch.cuda.device_count()} card(s); pass backend='gloo'")
    _build_libraries(device_type)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, nprocs=world_size, join=True, args=(
            world_size, "file://" + os.path.join(tmp, "store"), backend, device_type,
            tuple(jobs), iters, tmp))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                for r in range(world_size)]


def scaling_report(job: RankJob, counts: Sequence[int], runs: Sequence[List[dict]],
                   device_type: str) -> dict:
    """The report of one frame job's results ``runs[i]`` (one result a
    rank) at ``counts[i]`` ranks: the keys of the JAX package's report,
    the launches of each rank, and the devices the ranks had."""
    ms = [run[0]["ms"] for run in runs]
    first = runs[0][0]["frame"]
    cfg = job.cfg
    return {
        "counts": list(counts),
        "ms": ms,
        "efficiency": [ms[0] / (n * t) for n, t in zip(counts, ms)],
        "bitwise_equal": all(torch.equal(r["frame"], first) for run in runs for r in run),
        "platform": device_type,
        "devices": torch.cuda.device_count() if device_type == "cuda" else 1,
        "launches": [[r["launches"] for r in run] for run in runs],
        "config": {"scene": cfg.obj_path, "res": [cfg.xres, cfg.yres], "spp": cfg.samples,
                   "depth": cfg.k, "intersector": cfg.intersector},
    }


def measure_scaling(
    scene_spec: str,
    eye,
    center,
    up,
    yview: float,
    xres: int,
    yres: int,
    n_samples: int,
    depth: int,
    world_sizes: Sequence[int] = (1, 2),
    backend: Optional[str] = None,
    device=None,
    intersector: str = "auto",
    iters: int = 2,
    seed: int = 0,
) -> dict:
    """Time the same full-frame render at each world size; return a report
    (:func:`scaling_report`): ``counts``, ``ms``, ``efficiency`` (relative
    to the first count's time), ``bitwise_equal`` (every rank's frame at
    every count exactly equal: the counter-based PRNG's shard invariance),
    ``platform`` and ``config``.  ``scene_spec`` is ``load_scene``'s input
    (``builtin:cornell_box``, ``synthetic:atrium:262144``, an OBJ path);
    ``device`` and ``backend`` as in :func:`run_ranks`."""
    cfg = RenderConfig(
        obj_path=scene_spec, xres=xres, yres=yres, samples=n_samples, k=depth, seed=seed,
        intersector=intersector, yview=float(yview), use_preview=False,
        vp=tuple(map(float, eye)), la=tuple(map(float, center)), up=tuple(map(float, up)),
    )
    job = RankJob(cfg)
    runs = [[r[0] for r in run_ranks(n, [job], backend, device, iters)] for n in world_sizes]
    return scaling_report(job, world_sizes, runs, resolve_device(device).type)


def format_report(report: dict) -> str:
    c = report["config"]
    lines = [
        f"scaling sweep [{report['platform']}] {c['scene']} {c['res'][0]}x{c['res'][1]} @ "
        f"{c['spp']}spp depth={c['depth']} ({c['intersector']})",
        f"  shard-invariance (bitwise): {'OK' if report['bitwise_equal'] else 'FAIL'}",
    ]
    for n, t, e in zip(report["counts"], report["ms"], report["efficiency"]):
        lines.append(f"  {n:>3} rank(s): {t:8.1f} ms   eff {100 * e:5.1f}%")
    shared = max(report["counts"])
    if shared > report["devices"]:
        where = ("one CPU" if report["platform"] == "cpu" else
                 "one card" if report["devices"] == 1 else f"{report['devices']} cards")
        lines.append(f"  ({shared} ranks on {where}: harness and sharding semantics, "
                     "not a scaling efficiency)")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``python -m chiaroscuro_tpu_torch.parallel.scaling [scene.rtc] [key
    value ...]``: the sweep of the CLI's config (its input, camera,
    resolution, samples, k, seed, intersector and ``platform``) at 1, 2 and
    N ranks, N the cards present, over NCCL (``platform cpu``: 1 and 2 gloo
    ranks).  Without arguments, the Cornell box at 256x256 x 4 spp x k 3."""
    argv = sys.argv if argv is None else list(argv)
    if len(argv) > 1:
        cfg = RenderConfig.from_argv(argv)
    else:
        from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA as cam

        cfg = RenderConfig(obj_path="builtin:cornell_box", xres=256, yres=256, samples=4,
                           k=3, vp=cam["eye"], la=cam["center"], up=cam["up"],
                           yview=cam["yview"])
    device_type = resolve_device(cfg.platform).type
    if device_type == "cuda":
        n_dev = torch.cuda.device_count()
        counts = sorted({1, 2, n_dev} & set(range(1, n_dev + 1)))
    else:
        counts = [1, 2]
    report = measure_scaling(
        cfg.obj_path, cfg.vp, cfg.la, cfg.up, cfg.yview, cfg.xres, cfg.yres, cfg.samples,
        cfg.k, world_sizes=counts, device=device_type, intersector=cfg.intersector,
        seed=cfg.seed,
    )
    if device_type == "cuda":
        print(f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(format_report(report))


if __name__ == "__main__":
    main()
