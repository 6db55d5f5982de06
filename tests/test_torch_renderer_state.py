"""The port's renderer surface on the CPU: ``render_samples(spp_batch=)``,
progressive accumulation and its state files, and the per-phase profile,
held against the JAX package where it has the same surface
(tests/test_renderer_state.py ported).

The port renders through its dense pair (the plain K1/K2 on CPU tensors)
unless a test says otherwise; the JAX side through its brute oracle.

Tolerances, each with its reason:

- ``spp_batch`` against one sample a wavefront: mean relative difference
  <= 1e-6 and max |d| <= 1e-5 x the image's max.  Every (pixel, sample)
  keeps its PRNG stream, so only the order of the float sums differs.
- Against the JAX package's render: mean |d| <= 1e-4 x mean radiance and
  at most 0.5% of the pixels outside rtol 1e-3 (tests/test_torch_render.py).
- Progressive layers against one render: rtol 2e-6, atol 2e-7
  (tests/test_renderer_state.py): a 3-term mean of means against one mean.
- Within the port, a resumed render, checkpointing and compaction are
  bitwise: they run the same ops on the same inputs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.render.renderer import Renderer as JaxRenderer
from chiaroscuro_tpu.render.renderer import render_samples as jax_render_samples
from chiaroscuro_tpu.scene.builtin import cornell_box as jax_cornell_box
from chiaroscuro_tpu.scene.config import RenderConfig as JaxRenderConfig
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu.accel import make_intersectors as jax_make_intersectors
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.ops import intersect_cuda
from chiaroscuro_tpu_torch.ops.cluster_cuda import make_cluster_intersectors
from chiaroscuro_tpu_torch.render import integrator
from chiaroscuro_tpu_torch.render.renderer import Renderer, render_image, render_samples
from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    params_from_numpy,
    scene_tensors_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = CORNELL_CAMERA


@pytest.fixture(scope="module")
def scenes():
    sa = build_scene_arrays(jax_cornell_box())
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    return sa, scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")


def _pixels(xres, yres):
    ys, xs = torch.meshgrid(torch.arange(yres), torch.arange(xres), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _samples(scene, pair, xres, yres, n, **kw):
    px, py = _pixels(xres, yres)
    return render_samples(scene, CAM["eye"], CAM["center"], CAM["up"], CAM["yview"], xres,
                          yres, px, py, 0, n, 0, 3, (0.0, 0.0, 0.0), *pair, **kw)


def _assert_batch_close(img, ref):
    """The spp_batch bound of the module docstring."""
    d = (img - ref).abs()
    assert float((d / ref.abs().clamp_min(1e-30)).mean()) <= 1e-6
    assert float(d.max()) <= 1e-5 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# spp_batch.
# ---------------------------------------------------------------------------


def test_spp_batch_matches_one_sample_a_wavefront(scenes):
    """spp_batch 4 (and 8) against 1 over 8 samples, stats equal; a batch
    that does not divide n_samples is ignored (bitwise the unbatched
    render); the wavefront's closest queries drop from samples x k to
    samples / spp_batch x k."""
    _, scene = scenes
    pair = make_intersectors(scene, "dense")
    calls = []
    inner = pair[0].planar_fn

    def counted(o3, d3, live=None):
        calls.append(o3.shape[1])
        return inner(o3, d3, live=live)

    pair[0].planar_fn = counted
    ref, st = _samples(scene, pair, 20, 12, 8, with_stats=True)
    assert len(calls) == 8 * 3 and set(calls) == {2}
    for sb in (4, 8):
        calls.clear()
        img, st_b = _samples(scene, pair, 20, 12, 8, with_stats=True, spp_batch=sb)
        assert len(calls) == 8 // sb * 3 and set(calls) == {2 * sb}
        _assert_batch_close(img, ref)
        assert torch.equal(st_b, st)
    assert float(ref.mean()) > 1e-3
    assert torch.equal(_samples(scene, pair, 20, 12, 8, spp_batch=3), ref)


def test_spp_batch_matches_jax(scenes):
    """The port's spp_batch 4 render against JAX's
    ``render_samples(spp_batch=4)`` on the same scene (module bound)."""
    sa, scene = scenes
    px, py = (x.numpy().astype(np.int32) for x in _pixels(24, 16))
    cf, af = jax_make_intersectors(sa, "brute")
    ref = np.asarray(jax_render_samples(
        sa, jnp.asarray(CAM["eye"], jnp.float32), jnp.asarray(CAM["center"], jnp.float32),
        jnp.asarray(CAM["up"], jnp.float32), jnp.float32(CAM["yview"]), 24, 16,
        jnp.asarray(px), jnp.asarray(py), jnp.int32(0), 8, jnp.uint32(0), 3,
        jnp.zeros(3, jnp.float32), cf, af, spp_batch=4))
    img = _samples(scene, make_intersectors(scene, "dense"), 24, 16, 8, spp_batch=4).numpy()
    assert ref.mean() > 1e-3
    assert np.abs(img - ref).mean() <= 1e-4 * ref.mean()
    outside = ~np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    assert outside.mean() <= 0.005, outside.mean()


def test_spp_batch_with_checkpoint_gradients(scenes):
    """spp_batch composes with ``checkpoint=True``: the same loss and
    gradients bitwise, and within the batch bound of the unbatched ones."""
    _, scene = scenes
    fields = ("kd", "ke")

    def run(**kw):
        p = params_from_numpy({k: getattr(scene, k).numpy() for k in fields}, "cpu")
        s = scene.replace(**p)
        img = _samples(s, make_intersectors(s, "dense"), 16, 8, 4, **kw)
        img.mean().backward()
        return img.detach(), {k: v.grad for k, v in p.items()}

    img, g = run(spp_batch=4)
    img_c, g_c = run(spp_batch=4, checkpoint=True)
    img_1, g_1 = run()
    assert torch.equal(img_c, img)
    _assert_batch_close(img, img_1)
    for k in fields:
        assert torch.equal(g_c[k], g[k]), k
        assert torch.isfinite(g[k]).all() and bool(g[k].abs().sum() > 0), k
        torch.testing.assert_close(g[k], g_1[k], rtol=1e-5, atol=1e-7 * float(g_1[k].abs().max()))


@pytest.mark.parametrize("method", ["dense_segments", "cluster_sorted"])
def test_spp_batch_with_compaction(scenes, method):
    """spp_batch with bounce compaction is bitwise its uncompacted render:
    on the dense pair the 8,192-lane batched wavefront compacts in two
    COMPACT_SEG_LANES segments; on the cluster pair (forced spatial sort,
    per-light shadow sort) in one global sort."""
    _, scene = scenes
    if method == "dense_segments":
        pair = make_intersectors(scene, "dense")
        res, sb = (32, 32), 8
        assert res[0] * res[1] * sb == 2 * integrator.COMPACT_SEG_LANES
    else:
        pair = make_cluster_intersectors(scene, M=8, Lmax=8)
        pair[0].prefers_ray_sort = True
        res, sb = (16, 16), 4
    base, st = _samples(scene, pair, *res, 8, with_stats=True, compact=False, spp_batch=sb)
    out, st2 = _samples(scene, pair, *res, 8, with_stats=True, compact=True, spp_batch=sb)
    assert float(base.mean()) > 1e-3
    assert torch.equal(out.view(torch.int32), base.view(torch.int32))
    assert torch.equal(st, st2)


# ---------------------------------------------------------------------------
# Progressive accumulation and state files (tests/test_renderer_state.py).
# ---------------------------------------------------------------------------


def _cfg(cls=RenderConfig, **kw):
    kw.setdefault("xres", 24)
    kw.setdefault("yres", 16)
    kw.setdefault("k", 2)
    kw.setdefault("samples", 4)
    kw.setdefault("vp", (0.0, 1.0, 3.9))
    kw.setdefault("la", (0.0, 1.0, 0.0))
    if cls is RenderConfig:
        kw.setdefault("intersector", "dense")
        kw.setdefault("platform", "cpu")
    else:
        kw.setdefault("intersector", "brute")
    return cls(**kw)


def test_progressive_layers_equal_single_big_render(scenes):
    _, scene = scenes
    cfg = _cfg(samples=4)
    r = Renderer(scene, cfg)
    for _ in range(3):
        img = r.ray_trace()
    single = render_image(scene, cfg, n_samples=12).numpy()
    np.testing.assert_allclose(img, single, rtol=2e-6, atol=2e-7)
    assert r._layers == 3


def test_camera_move_resets_accumulation(scenes):
    """Moving the eye resets (rayTracer.cpp:27-33); changing only ``up``
    does not (the reference's lastUp == lastUp quirk, rayTracer.cpp:24)."""
    _, scene = scenes
    cfg = _cfg()
    r = Renderer(scene, cfg)
    r.ray_trace()
    r.ray_trace(up=(0.1, 0.9, 0.0))
    assert r._layers == 2
    r.ray_trace(eye=(0.0, 1.1, 3.9))
    assert r._layers == 1
    fresh = Renderer(scene, cfg).ray_trace(eye=(0.0, 1.1, 3.9))
    np.testing.assert_array_equal(r.pixels, fresh)


def test_state_roundtrip_resumes_exactly(scenes, tmp_path):
    """save_state, load_state into a fresh renderer, one more layer:
    bitwise the renderer that never stopped."""
    _, scene = scenes
    cfg = _cfg(samples=2)
    path = str(tmp_path / "acc.npz")
    a = Renderer(scene, cfg)
    a.ray_trace()
    a.ray_trace()
    a.save_state(path)
    b = Renderer(scene, cfg)
    assert b.load_state(path)
    assert b._layers == 2
    np.testing.assert_array_equal(b.pixels, a.pixels)
    b.ray_trace()
    a.ray_trace()
    assert b._layers == a._layers == 3
    np.testing.assert_array_equal(b.pixels, a.pixels)
    assert b.max_val == a.max_val


def test_state_rejects_incompatible(scenes, tmp_path):
    _, scene = scenes
    path = str(tmp_path / "acc.npz")
    a = Renderer(scene, _cfg(samples=2))
    a.ray_trace()
    a.save_state(path)
    assert not Renderer(scene, _cfg(samples=3)).load_state(path)
    assert not Renderer(scene, _cfg(samples=2, seed=7)).load_state(path)
    assert not Renderer(scene, _cfg(samples=2, xres=32)).load_state(path)
    assert not Renderer(scene, _cfg(samples=2)).load_state(str(tmp_path / "missing.npz"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_files_cross_packages(scenes, tmp_path, writer):
    """A state file written by one package loads in the other, which
    resumes the same sample stream: the resumed layer 3 equals the writer's
    own layer 3 to the module's render bound, and the restored pixels equal
    the writer's exactly."""
    sa, scene = scenes
    path = str(tmp_path / "acc.npz")
    port = Renderer(scene, _cfg(samples=2))
    jaxr = JaxRenderer(sa, _cfg(JaxRenderConfig, samples=2))
    src, dst = (jaxr, port) if writer == "jax" else (port, jaxr)
    src.ray_trace()
    src.ray_trace()
    src.save_state(path)
    assert dst.load_state(path)
    assert dst._layers == 2
    np.testing.assert_array_equal(np.asarray(dst.pixels), np.asarray(src.pixels))
    src.ray_trace()
    dst.ray_trace()
    assert dst._layers == 3
    img, ref = np.asarray(dst.pixels), np.asarray(src.pixels)
    assert np.abs(img - ref).mean() <= 1e-4 * ref.mean()
    outside = ~np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    assert outside.mean() <= 0.005, outside.mean()


# ---------------------------------------------------------------------------
# Profiling and the CLI.
# ---------------------------------------------------------------------------


def test_profile_phases_keys_match_jax(scenes):
    """profile_phases returns JAX's keys, every value non-negative and the
    frame's positive, and the report names each phase."""
    from chiaroscuro_tpu.utils import profiling as jprofiling

    from chiaroscuro_tpu_torch.utils import profiling

    sa, scene = scenes
    args = (CAM["eye"], CAM["center"], CAM["up"], CAM["yview"], 16, 16, 2, 2)
    phases = profiling.profile_phases(scene, *make_intersectors(scene, "dense"), *args,
                                      seed=0, iters=1)
    ref = jprofiling.profile_phases(sa, *jax_make_intersectors(sa, "brute"), *args,
                                    seed=0, iters=1)
    assert set(phases) == set(ref) == {"raygen", "closest", "shadow", "shade+control", "full"}
    assert all(v >= 0.0 for v in phases.values()) and phases["full"] > 0.0
    report = profiling.format_phase_report(phases)
    for name in phases:
        assert name in report
    assert profiling.issued_ray_queries(16, 16, 2, 2) == jprofiling.issued_ray_queries(16, 16, 2, 2)


def test_cli_profile_on(tmp_path, capsys):
    """``profile on`` renders, prints the phase report after the render and
    exports the image, on the CPU, with ``specular on``."""
    from chiaroscuro_tpu_torch import cli
    from chiaroscuro_tpu_torch.render.image_io import read_exr

    out = tmp_path / "cornell.exr"
    before = dict(intersect_cuda.LAUNCHES)
    r = cli.run(["chiaroscuro_tpu_torch", os.path.join(REPO, "scenes", "cornell.rtc"),
                 "no-preview", "platform", "cpu", "xres", "16", "yres", "12",
                 "samples", "2", "k", "2", "profile", "on", "specular", "on",
                 "output", str(out)])
    text = capsys.readouterr().out
    assert text.index("took") < text.index("phase breakdown (full") < text.index(
        "Render succesfully saved")
    assert "Kernel launches: none" in text and intersect_cuda.LAUNCHES == before
    assert r.cfg.profile and r.cfg.enable_specular
    img = read_exr(str(out))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all() and img.max() > 0.0
