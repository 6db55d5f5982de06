"""Multi-process distributed rendering (torch port of
``chiaroscuro_tpu/parallel/multihost.py``).

The reference is strictly single-process.  Here the tile-sharded renderer
(``parallel/sharding.py``) runs one process a card, on one host or several:

- :func:`initialize` wires ``torch.distributed`` (NCCL by default; gloo
  where the caller names it, for ranks on the CPU or sharing a card).
  Launched by ``torchrun``, it reads the rendezvous from the environment
  (``env://``); otherwise the caller gives the coordinator's address, the
  number of processes and this process's rank.
- :func:`global_tile_mesh` spans every rank of the job;
  ``render_frame_sharded`` / ``sharded_value_and_grad`` work unchanged, and
  their collectives cross hosts.
- The counter-based PRNG keys randomness on *global* pixel ids, so an
  N-rank render is bitwise identical to the 1-rank render.
- :func:`export_on_process_zero` writes the frame from rank 0 only (every
  rank holds the gathered frame).

The batch render across ranks, one a card:
``torchrun --nproc-per-node N -m chiaroscuro_tpu_torch.parallel.multihost
scene.rtc [key value ...]`` (:func:`main`).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from chiaroscuro_tpu_torch.parallel.sharding import TileMesh, make_tile_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Start ``torch.distributed`` when running multi-process.

    No-op at ``num_processes <= 1`` or when a group is already initialised.
    Without an address the rendezvous is torchrun's ``env://``; a
    ``host:port`` address becomes ``tcp://host:port`` (an address with a
    scheme, such as ``file://``, is used as given).  The backend is NCCL
    unless the caller names another.  Where cards are present each rank then
    takes the card ``LOCAL_RANK`` (else its rank modulo the cards present).
    Errors of the rendezvous propagate."""
    if num_processes is not None and num_processes <= 1:
        return
    if dist.is_initialized():
        return
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the NCCL backend needs a CUDA device; name backend='gloo' "
                           "to run ranks on the CPU")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend=backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
    if torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())


def global_tile_mesh(axis: str = "tile", device=None) -> TileMesh:
    """1-D mesh over every rank of the job (all hosts), on this rank's
    device (the current card unless ``device`` names another)."""
    return make_tile_mesh(device=device, axis=axis)


def is_process_zero() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def export_on_process_zero(path: str, pixels, exposure: float = 5.0) -> None:
    """Write the frame (already gathered on every rank by
    ``render_frame_sharded``) from rank 0 only."""
    if not is_process_zero():
        return
    from chiaroscuro_tpu_torch.render.image_io import write_image

    if isinstance(pixels, torch.Tensor):
        pixels = pixels.detach().cpu().numpy()
    write_image(path, np.asarray(pixels), exposure)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The CLI's batch render (``RenderConfig.from_argv``: a ``.rtc`` file
    and ``key value`` overrides) split over the ranks of a torchrun job,
    one card a rank (``platform cpu``: gloo ranks on the CPU; one process
    without torchrun); rank 0 prints the frame's seconds and exports it."""
    from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
    from chiaroscuro_tpu_torch.parallel.sharding import render_frame_sharded
    from chiaroscuro_tpu_torch.scene.config import RenderConfig
    from chiaroscuro_tpu_torch.scene.scene_arrays import load_scene

    cfg = RenderConfig.from_argv(sys.argv if argv is None else list(argv))
    initialize(num_processes=int(os.environ.get("WORLD_SIZE", "1")),
               backend="gloo" if cfg.platform == "cpu" else None)
    mesh = global_tile_mesh(device=cfg.platform if cfg.platform == "cpu" else None)
    scene = load_scene(cfg, mesh.device)
    pair = make_intersectors(scene, cfg.intersector)
    t0 = time.perf_counter()
    frame = render_frame_sharded(scene, mesh, cfg.vp, cfg.la, cfg.up, cfg.yview, cfg.xres,
                                 cfg.yres, cfg.samples, cfg.seed, cfg.k, cfg.background, *pair)
    seconds = time.perf_counter() - t0
    if is_process_zero():
        print(f"{mesh.size} rank(s) on {mesh.device.type}: {cfg.xres}x{cfg.yres} x "
              f"{cfg.samples} spp x k{cfg.k} in {seconds:.3f} s (first frame)")
    export_on_process_zero(cfg.render_path, frame, cfg.exposure)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
