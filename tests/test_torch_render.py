"""The port's renderer on the CPU against the JAX package and its golden.

Both packages render the very same scene: the JAX ``SceneArrays`` of the
builtin Cornell box is read out as numpy and carried into the port with
``scene_tensors_from_numpy``.  The port runs the dense intersector, which on
CPU tensors takes the kernels' plain torch versions; the JAX side runs its
brute oracle, as the golden fixture does.

Bound for the image comparisons: mean |diff| <= 1e-4 x mean radiance, and at
most 0.5% of pixels outside rtol 1e-3 (tighter bounds where stated).  The
two packages run the same estimator with the same Threefry streams, but XLA
and torch round transcendental and fused ops differently at the ulp level;
a ulp can flip a Russian-roulette decision or a near-tie hit id, which
changes a whole path, so a few pixels may differ by far more than rounding
while the mean stays tight.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chiaroscuro_tpu.render.image_io import read_exr as jax_read_exr
from chiaroscuro_tpu.render.renderer import render_image as jax_render_image
from chiaroscuro_tpu.scene.builtin import cornell_box as jax_cornell_box
from chiaroscuro_tpu.scene.config import RenderConfig as JaxRenderConfig
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu_torch.ops import intersect_cuda
from chiaroscuro_tpu_torch.render.renderer import Renderer, render_image
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    scene_tensors_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "cornell_64.exr")
# tools/make_goldens.py FIXTURES["cornell_64"]
TOKENS = [
    "input", "builtin:cornell_box", "xres", "64", "yres", "64",
    "samples", "8", "k", "3",
]


def assert_render_close(img, ref, mean_rel=1e-4, outlier_share=0.005):
    """The bound stated in the module docstring."""
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    mean_abs = float(np.abs(img - ref).mean())
    assert mean_abs <= mean_rel * float(ref.mean()), (mean_abs, float(ref.mean()))
    outside = ~np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    assert outside.mean() <= outlier_share, outside.mean()


@pytest.fixture(scope="module")
def jax_scene():
    return build_scene_arrays(jax_cornell_box())


@pytest.fixture(scope="module")
def scene(jax_scene):
    fields = {k: np.asarray(getattr(jax_scene, k)) for k in DATA_FIELDS}
    meta = {k: getattr(jax_scene, k) for k in META_FIELDS}
    return scene_tensors_from_numpy(fields, meta, "cpu")


@pytest.fixture(scope="module")
def port_render(scene):
    cfg = RenderConfig.from_tokens(TOKENS + ["platform", "cpu"])
    img, stats = render_image(scene, cfg, with_stats=True)
    return img.numpy(), stats.numpy()


@pytest.fixture(scope="module")
def jax_render(jax_scene):
    cfg = JaxRenderConfig.from_tokens(TOKENS + ["intersector", "brute"])
    img, stats = jax_render_image(jax_scene, cfg, with_stats=True)
    return np.asarray(img), np.asarray(stats)


def test_render_matches_jax(port_render, jax_render):
    """Found on this Cornell 64x64 frame: the images agree to float32
    rounding (see the bound asserted), and the useful-query counts, which
    are integers, agree exactly."""
    (img, stats), (ref, ref_stats) = port_render, jax_render
    # Non-trivial content guard (tests/test_self_golden.py).
    assert ref.max() > 0.1 and (ref > 1e-3).mean() > 0.05
    assert_render_close(img, ref)
    np.testing.assert_array_equal(stats, ref_stats.astype(np.int64))


def test_render_matches_golden(port_render):
    """Against the committed self-golden at its own tolerance
    (tests/test_self_golden.py: rtol 2e-3, atol 1e-4 — the EXR HALF
    quantization), under the same outlier bound."""
    img, _ = port_render
    golden = jax_read_exr(GOLDEN)
    assert img.shape == golden.shape
    outside = ~np.isclose(img, golden, rtol=2e-3, atol=1e-4).all(axis=-1)
    assert outside.mean() <= 0.005, outside.mean()
    assert np.abs(img - golden).mean() <= 1e-3 * golden.mean()


def test_cpu_render_launches_no_kernel(scene):
    before = dict(intersect_cuda.LAUNCHES)
    cfg = RenderConfig.from_tokens(TOKENS + ["xres", "8", "yres", "8", "platform", "cpu"])
    render_image(scene, cfg)
    assert intersect_cuda.LAUNCHES == before


def test_two_layers_equal_one_render_at_twice_spp(scene, capsys):
    """Layer i renders the disjoint sample range [(i-1)*spp, i*spp), so the
    running average of two layers is a 2*spp render up to the order of the
    float sums (one rounding of the average, rtol 1e-6)."""
    cfg = RenderConfig.from_tokens(
        TOKENS + ["xres", "16", "yres", "16", "samples", "2", "platform", "cpu"]
    )
    r = Renderer(scene, cfg)
    r.ray_trace()
    two = r.ray_trace().copy()
    assert r._layers == 2
    one = render_image(scene, cfg, n_samples=4).numpy()
    np.testing.assert_allclose(two, one, rtol=1e-6, atol=1e-7)
    # Changing `up` does not reset accumulation (the reference's quirk).
    r.ray_trace(up=(1.0, 0.0, 0.0))
    assert r._layers == 3
    assert r.last_stats["queries_useful"] > 0
    assert "Rendering image of size 16x16 with 6 samples" in capsys.readouterr().out


def test_spp_chunks_equal_one_pass(scene):
    """spp-chunk renders the same samples in slices; only the float sums
    regroup (rtol 1e-6)."""
    cfg = RenderConfig.from_tokens(
        TOKENS + ["xres", "16", "yres", "16", "samples", "3", "platform", "cpu"]
    )
    one, stats = render_image(scene, cfg, with_stats=True)
    cfg.spp_chunk = 2
    chunked, chunked_stats = render_image(scene, cfg, with_stats=True)
    torch.testing.assert_close(chunked, one, rtol=1e-6, atol=1e-7)
    assert torch.equal(chunked_stats, stats)


def test_cli_writes_exr_that_reads_back(tmp_path):
    from chiaroscuro_tpu_torch.render.image_io import read_exr

    out = tmp_path / "cornell.exr"
    proc = subprocess.run(
        [
            sys.executable, "-m", "chiaroscuro_tpu_torch",
            os.path.join(REPO, "scenes", "cornell.rtc"), "no-preview",
            "platform", "cpu", "xres", "16", "yres", "12", "samples", "2",
            "k", "2", "output", str(out),
        ],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Render succesfully saved" in proc.stdout
    img = read_exr(str(out))
    assert img.shape == (12, 16, 3)
    assert np.isfinite(img).all() and img.max() > 0.0
    # The same file through the JAX package's reader.
    np.testing.assert_array_equal(jax_read_exr(str(out)), img)


def test_render_samples_is_tiling_invariant(scene):
    """A tile of pixels renders as the same pixels of the full frame."""
    from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
    from chiaroscuro_tpu_torch.render.renderer import render_samples

    cfg = RenderConfig.from_tokens(TOKENS + ["xres", "16", "yres", "16", "platform", "cpu"])
    cf, af = make_intersectors(scene, "dense")
    ys, xs = torch.meshgrid(torch.arange(16), torch.arange(16), indexing="ij")
    args = (scene, cfg.vp, cfg.la, cfg.up, cfg.yview, 16, 16)
    full = render_samples(*args, xs.reshape(-1), ys.reshape(-1), 0, 2, 0, 3,
                          cfg.background, cf, af)
    sel = torch.arange(37, 37 + 50)
    tile = render_samples(*args, xs.reshape(-1)[sel], ys.reshape(-1)[sel], 0, 2,
                          0, 3, cfg.background, cf, af)
    torch.testing.assert_close(tile, full[sel], rtol=0, atol=0)
