"""Faults planted under a run, by name, for the benchmark's own tests and
for reading a fault's numbers on the card (``benchmarks/control.py``); the
benchmark's runs plant none.  Each breaks the port where it computes, so
that the run's comparison with the reference has to catch it:

- ``state_unchanged``: a pass leaves the accumulated image as it was; a
  step hands back zero gradients, so the materials never move;
- ``half_batch``: a pass renders only the upper half of the image and the
  image keeps nothing of the rest; a step renders only the first half of
  its pixels and the loss and gradients are taken over those twice;
- ``altered``: what a pass or a step renders is scaled where it is produced
  (by 1.01 and 1.001);
- ``no_exchange``: the all-gather of a sharded pass moves nothing, so each
  rank keeps only its own tile;
- ``loads:<module>``: the process that plants it (each rank of a sharded
  run) imports ``<module>``, as a port that loaded a forbidden library
  would; the run has to fail with no result.
"""

from __future__ import annotations

import importlib

import torch

NAMES = ("state_unchanged", "half_batch", "altered", "no_exchange")
_planted = set()


def apply(names) -> None:
    """Plant each named fault once in this process."""
    for name in names:
        if name.startswith("loads:"):
            importlib.import_module(name[len("loads:"):])
            continue
        if name not in NAMES:
            raise ValueError(f"unknown fault {name!r}")
        if name not in _planted:
            globals()["_" + name]()
            _planted.add(name)


def _state_unchanged():
    from chiaroscuro_tpu_torch.parallel import sharding
    from chiaroscuro_tpu_torch.render.renderer import Renderer

    orig = Renderer.ray_trace

    def ray_trace(self, *a, **k):
        kept = getattr(self, "_fault_kept", None)
        out = orig(self, *a, **k)
        if kept is None:
            self._fault_kept = out.copy()
            return out
        self.pixels = kept.copy()
        return self.pixels

    Renderer.ray_trace = ray_trace
    svg = sharding.sharded_value_and_grad

    def sharded_value_and_grad(*a, **k):
        make = svg(*a, **k)

        def make2(mesh, kw):
            run = make(mesh, kw)

            def run2(*x):
                loss, grads = run(*x)
                return loss, {f: torch.zeros_like(g) for f, g in grads.items()}
            return run2
        return make2

    sharding.sharded_value_and_grad = sharded_value_and_grad


def _half_batch():
    from chiaroscuro_tpu_torch.parallel import sharding
    from chiaroscuro_tpu_torch.render import renderer

    render_image = renderer.render_image

    def half_image(scene, cfg, *a, **k):
        img, stats = render_image(scene, cfg, *a, **k)
        keep = torch.arange(img.shape[0], device=img.device)[:, None, None] < img.shape[0] // 2
        return torch.where(keep, img, 0.0), stats

    renderer.render_image = half_image
    render_samples = sharding.render_samples

    def half_samples(scene, *a, px, py, **k):
        h = px.shape[0] // 2
        img = render_samples(scene, *a, px=px[:h], py=py[:h], **k)
        return torch.cat([img, img])

    sharding.render_samples = half_samples


def _altered():
    from chiaroscuro_tpu_torch.parallel import sharding
    from chiaroscuro_tpu_torch.render import renderer

    render_image = renderer.render_image

    def altered_image(*a, **k):
        img, stats = render_image(*a, **k)
        return img * 1.01, stats

    renderer.render_image = altered_image
    render_samples = sharding.render_samples

    def altered_samples(*a, **k):
        return render_samples(*a, **k) * 1.001

    sharding.render_samples = altered_samples


def _no_exchange():
    from chiaroscuro_tpu_torch.parallel import sharding

    def all_gather(parts, send, group=None):
        me = sharding.dist.get_rank(group)
        for i, p in enumerate(parts):
            p.copy_(send if i == me else torch.zeros_like(send))

    sharding.dist = type("NoExchange", (), {
        "all_gather": staticmethod(all_gather),
        "get_backend": staticmethod(sharding.dist.get_backend),
        "get_rank": staticmethod(sharding.dist.get_rank),
        "all_reduce": staticmethod(sharding.dist.all_reduce),
        "ReduceOp": sharding.dist.ReduceOp,
        "is_initialized": staticmethod(sharding.dist.is_initialized),
        "get_world_size": staticmethod(sharding.dist.get_world_size),
        "group": sharding.dist.group,
    })
