"""Entry points: the single-card forward step and the multi-rank dry
run (torch port of the repo's ``__graft_entry__.py``).

``entry()`` returns the forward render step on the flagship scene (the
Cornell box path trace) with its arguments, and ``dryrun_multichip(n)``
runs the full differentiable step (render -> pixel loss -> scene-parameter
gradients) over n ranks, pixel tiles sharded and the gradients all-reduced.

Both run on the card unless the caller asks for ``device="cpu"``.  The dry
run needs one card a rank: where fewer cards exist it raises, and it never
drops to CPU ranks by itself.
"""

from __future__ import annotations

import numpy as np
import torch

# The fields the dry run differentiates: materials and geometry.
DRYRUN_FIELDS = ("kd", "ke", "tri_v0", "tri_v1", "tri_v2")


def _flagship_cfg(xres: int, yres: int, samples: int, depth: int, intersector: str):
    from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA as C
    from chiaroscuro_tpu_torch.scene.config import RenderConfig

    return RenderConfig(
        obj_path="builtin:cornell_box", xres=xres, yres=yres, samples=samples, k=depth,
        seed=0, intersector=intersector, vp=C["eye"], la=C["center"], up=C["up"],
        yview=C["yview"], use_preview=False,
    )


def entry(device=None):
    """(fn, example_args): the forward render step on one card, 64x64 x 2
    spp x k 3 of the Cornell box through the dense pair (K1/K2);
    ``fn(*args)`` returns the (64, 64, 3) frame."""
    from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
    from chiaroscuro_tpu_torch.parallel.sharding import _pixel_grid, resolve_device
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.scene.scene_arrays import load_scene

    dev = resolve_device(device)
    cfg = _flagship_cfg(64, 64, 2, 3, "dense")
    scene = load_scene(cfg, dev)
    px, py = (torch.from_numpy(a).to(dev) for a in _pixel_grid(cfg.xres, cfg.yres))

    def fn(scene, eye, center, up, px, py):
        closest_fn, any_fn = make_intersectors(scene, cfg.intersector)
        flat = render_samples(
            scene, eye, center, up, cfg.yview, cfg.xres, cfg.yres, px, py,
            sample_start=0, n_samples=cfg.samples, seed=cfg.seed, depth=cfg.k,
            background=cfg.background, closest_fn=closest_fn, any_fn=any_fn,
        )
        return flat.reshape(cfg.yres, cfg.xres, 3)

    return fn, (scene, cfg.vp, cfg.la, cfg.up, px, py)


def dryrun_multichip(n_devices: int, intersector=None, device=None):
    """Run the FULL differentiable step over ``n_devices`` ranks: the
    Cornell box at 8 x n_devices pixels (one pixel row a rank), 1 spp,
    depth 2; the MSE against a black target, differentiated with respect to
    ``DRYRUN_FIELDS``; loss and gradients all-reduced (NCCL, one card a
    rank; gloo with ``device="cpu"``).  Asserts that all of them are
    finite, prints one line, and returns (loss, {field: gradient}).

    The intersector is ``dense`` (K1/K2 with the closest hit's backward on
    the card, their plain versions on the CPU) unless ``intersector`` names
    another.  Raises where fewer than ``n_devices`` cards exist and the
    caller did not ask for the CPU."""
    from chiaroscuro_tpu_torch.parallel.scaling import RankJob, run_ranks
    from chiaroscuro_tpu_torch.parallel.sharding import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} cards, found "
            f"{torch.cuda.device_count()}; pass device='cpu' for CPU ranks"
        )
    cfg = _flagship_cfg(8, n_devices, 1, 2, intersector or "dense")
    ranks = run_ranks(n_devices, [RankJob(cfg, fields=DRYRUN_FIELDS)], device=dev.type)
    loss, grads = ranks[0][0]["loss"], ranks[0][0]["grads"]
    for r in ranks[1:]:
        if not (torch.equal(r[0]["loss"], loss)
                and all(torch.equal(r[0]["grads"][k], g) for k, g in grads.items())):
            raise AssertionError("the ranks disagree on the all-reduced loss or gradients")
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")
    for name, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite grad for {name}")
    print(
        f"dryrun_multichip({n_devices}): loss={loss:.6f}, "
        f"|grad kd|={float(grads['kd'].abs().sum()):.6f} — OK"
    )
    return loss, grads


if __name__ == "__main__":
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    print("entry() ran:", tuple(out.shape), float(out.mean()))
    dryrun_multichip(torch.cuda.device_count())
