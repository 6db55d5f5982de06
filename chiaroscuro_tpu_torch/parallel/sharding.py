"""Tile-sharded rendering and gradient all-reduce on ``torch.distributed``
(torch port of ``chiaroscuro_tpu/parallel/sharding.py``).

The reference's only parallelism is an OpenMP ``parallel for`` over image
rows on one CPU (``src/rayTracer.cpp:55``).  Here the **pixel grid** is
split over the ranks of a process group: rank r renders the contiguous slice
``[r*n, (r+1)*n)`` of the flat row-major grid, and the tiles are
all-gathered.  The counter-based PRNG (``sampling/prng.py``) keys every
sample on the *global* pixel index, and every intersector answers each ray
exactly whatever rows it is batched with, so the assembled frame is bitwise
the same for any number of ranks.

For differentiable rendering, :func:`sharded_value_and_grad` runs the loss
on each rank's tile and sums the scene-parameter gradients over the ranks
with ``all_reduce(SUM)``, the counterpart of the JAX package's ``psum``
(scene parameters are replicated; rays are the "batch").

Collectives follow the group's backend: NCCL gathers and reduces the
tensors where they lie, on the card; gloo takes host tensors, so the tiles
and gradients are copied to the host for the collective and back to the
rank's device after it.  The render itself never leaves the rank's device.
Two ranks on one card need gloo (NCCL refuses them); nothing here picks a
backend.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.render.renderer import render_samples
from chiaroscuro_tpu_torch.scene.scene_arrays import SceneTensors


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another (``"cpu"``).  Raises where a card is asked for and none exists;
    a bare ``"cuda"`` becomes the current card."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the "
                "CPU with the kernels' plain torch versions"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """The counterpart of the JAX package's 1-D ``Mesh``: this process's
    place in a process group.  ``group`` is None where no group is
    initialised (one rank, no collective)."""

    axis_names: Tuple[str, ...]
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device


def make_tile_mesh(group=None, device=None, axis: str = "tile") -> TileMesh:
    """This process's tile mesh over ``group`` (the default group when
    None); with no group initialised, a 1-rank mesh.  ``device`` is the
    rank's device (:func:`resolve_device`)."""
    device = resolve_device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a group was given, but torch.distributed is not initialised")
        return TileMesh((axis,), None, 0, 1, device)
    group = dist.group.WORLD if group is None else group
    return TileMesh((axis,), group, dist.get_rank(group), dist.get_world_size(group), device)


def _pixel_grid(xres: int, yres: int):
    ys, xs = np.meshgrid(
        np.arange(yres, dtype=np.int32),
        np.arange(xres, dtype=np.int32),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


def _rank_slice(mesh: TileMesh, px, py, device):
    """This rank's contiguous slice of the global pixel columns and rows
    (numpy arrays or tensors), on ``device``."""
    total = len(px)
    if total % mesh.size:
        raise ValueError(f"{total} pixels not divisible by {mesh.size} ranks")
    n = total // mesh.size
    sl = slice(mesh.rank * n, (mesh.rank + 1) * n)
    return tuple(a[sl].to(device) if isinstance(a, torch.Tensor)
                 else torch.as_tensor(np.asarray(a[sl]), device=device) for a in (px, py))


def _wire(t: torch.Tensor, mesh: TileMesh) -> torch.Tensor:
    """``t`` where the group's backend takes it: the card for NCCL, the host
    for gloo."""
    return t.contiguous() if dist.get_backend(mesh.group) == "nccl" else t.cpu()


def _all_reduce(t: torch.Tensor, mesh: TileMesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, on the mesh's device."""
    if mesh.group is None:
        return t
    t = _wire(t, mesh).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t.to(mesh.device)


def render_frame_sharded(
    scene: SceneTensors,
    mesh: TileMesh,
    eye,
    center,
    up,
    yview,
    xres: int,
    yres: int,
    n_samples: int,
    seed: int,
    depth: int,
    background,
    closest_fn,
    any_fn,
    sample_start: int = 0,
) -> torch.Tensor:
    """Full frame, row-major tiles split over the mesh's ranks and
    all-gathered: (yres, xres, 3) on every rank, on the mesh's device.

    ``yres * xres`` must divide evenly by the number of ranks.  The frame
    carries no autograd graph (the gather ends it): for gradients use
    :func:`sharded_value_and_grad`."""
    if scene.device != mesh.device:
        raise ValueError(f"the scene is on {scene.device}, the mesh's rank on {mesh.device}")
    px, py = _rank_slice(mesh, *_pixel_grid(xres, yres), scene.device)
    with torch.no_grad():
        tile = render_samples(
            scene, eye, center, up, yview, xres, yres, px, py,
            sample_start, n_samples, seed, depth, background, closest_fn, any_fn,
        )
        if mesh.group is not None:
            send = _wire(tile, mesh)
            parts = [torch.empty_like(send) for _ in range(mesh.size)]
            dist.all_gather(parts, send, group=mesh.group)
            tile = torch.cat(parts).to(mesh.device)
    return tile.reshape(yres, xres, 3)


def sharded_value_and_grad(
    loss_of_image: Callable[[torch.Tensor], torch.Tensor],
    diff_fields: Tuple[str, ...] = ("kd", "ke"),
):
    """Build the sharded step: ``make(mesh, render_kwargs)`` returns
    ``run(scene, px, py) -> (loss, grads)``.

    ``px``/``py`` are the global pixel columns and rows; each rank takes its
    contiguous slice.  ``render_kwargs`` are :func:`render_samples`'s
    keywords apart from the tile and the intersectors (eye, center, up,
    yview, xres, yres, sample_start, n_samples, seed, depth, background, and
    optionally checkpoint or spp_batch), plus ``intersector`` (a
    :func:`make_intersectors` name) and, for the cluster path, ``clusters``
    (a prebuilt ``ClusterArrays``).  ``run`` substitutes leaves that
    require grad for ``diff_fields`` (``SceneTensors.replace``) and rebuilds
    the pair from the substituted scene, since a pair built on the original
    scene carries no gradient to the vertices.

    ``loss_of_image`` maps the tile's (R, 3) radiance to a scalar; each rank
    differentiates ``loss_of_image(tile) / size``, and the losses and the
    gradients are summed over the ranks (``all_reduce``), so every rank
    holds the global loss and gradient.  The loss is detached."""

    def make(mesh: TileMesh, render_kwargs: dict):
        kwargs = dict(render_kwargs)
        intersector = kwargs.pop("intersector")
        clusters = kwargs.pop("clusters", None)

        def run(scene: SceneTensors, px, py):
            px_t, py_t = _rank_slice(mesh, px, py, scene.device)
            params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
                      for f in diff_fields}
            s = scene.replace(**params)
            closest_fn, any_fn = make_intersectors(s, intersector, clusters=clusters)
            img = render_samples(s, px=px_t, py=py_t, closest_fn=closest_fn,
                                 any_fn=any_fn, **kwargs)
            loss = loss_of_image(img) / mesh.size
            loss.backward()
            grads = {f: _all_reduce(p.grad if p.grad is not None else torch.zeros_like(p), mesh)
                     for f, p in params.items()}
            return _all_reduce(loss.detach(), mesh), grads

        return run

    return make
