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


# ---------------------------------------------------------------------------
# The cluster path: compaction, the spatial sort keys, the atrium.
# ---------------------------------------------------------------------------

ATRIUM_CAM = ["VP", "1.8", "4.2", "5.0", "LA", "24", "3.2", "6.8",
              "UP", "0", "1", "0", "yview", "0.9"]
ATRIUM_GOLDEN = os.path.join(REPO, "tests", "golden", "atrium_160x90.exr")


@pytest.fixture(scope="module")
def atrium_scenes():
    from chiaroscuro_tpu.scene.synthetic import atrium as jax_atrium

    sa = build_scene_arrays(jax_atrium(2_200, seed=5))
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    return sa, scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")


def _render_tile(scene, cf, af, compact, xres=16, yres=16, spp=2, depth=3):
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA as cam

    ys, xs = torch.meshgrid(torch.arange(yres), torch.arange(xres), indexing="ij")
    return render_samples(
        scene, cam["eye"], cam["center"], cam["up"], cam["yview"], xres, yres,
        xs.reshape(-1), ys.reshape(-1), 0, spp, 7, depth, (0.0, 0.0, 0.0),
        cf, af, with_stats=True, compact=compact,
    )


@pytest.mark.parametrize("method", ["dense", "cluster_sorted"])
def test_compaction_bitwise_identity(atrium_scenes, scene, method):
    """Bounce compaction is a pure lane permutation: radiance and the
    useful-query counts bitwise those of the uncompacted wavefront
    (tests/test_integrator.py:292-387).  ``cluster_sorted`` forces the
    cluster path's spatial bounce sort and the per-light shadow sort
    (_sorted_any) on a small atrium (K = 85 at M = 32, 24 lights), whose K
    is below the COMPACT_MIN_K gate; the int payloads ride the gather as
    float bits."""
    from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
    from chiaroscuro_tpu_torch.ops.cluster_cuda import make_cluster_intersectors

    if method == "dense":
        s = scene
        cf, af = make_intersectors(s, "dense")
    else:
        s = atrium_scenes[1]
        cf, af = make_cluster_intersectors(s, M=32)
        cf.prefers_compaction = cf.prefers_ray_sort = True
    base, st = _render_tile(s, cf, af, compact=False)
    assert float(base.mean()) > 1e-4
    out, st2 = _render_tile(s, cf, af, compact=True)
    assert torch.equal(out.view(torch.int32), base.view(torch.int32))
    assert torch.equal(st, st2)
    if method != "dense":
        # compact=None takes the intersector's preference.
        assert torch.equal(_render_tile(s, cf, af, compact=None)[0], base)


def _jax_nested(name, **cells):
    """A nested function of the JAX ``trace_paths_planar`` (its spatial key
    helpers are closures there), rebuilt from its code object with the
    given closure cells, so the port's keys can be held against JAX's own
    expressions."""
    import types

    from chiaroscuro_tpu.render import integrator as jint

    code = next(c for c in jint.trace_paths_planar.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    closure = tuple(types.CellType(cells[v]) for v in code.co_freevars)
    return types.FunctionType(code, jint.__dict__, name, None, closure)


def test_spatial_keys_equal_jax(atrium_scenes):
    """The bounce-sort key and the shadow-sort order equal JAX's on the same
    state, light ids past the 1024 clamp included; the key width is checked
    (_DIR_BITS >= 7 would overflow int32)."""
    import jax.numpy as jnp

    from chiaroscuro_tpu_torch.render import integrator as tint

    sa, s = atrium_scenes
    rng = np.random.default_rng(21)
    B = (6, 128)
    lo, hi = s.world_min.numpy(), s.world_max.numpy()
    o = rng.uniform(lo[:, None, None] - 1.0, hi[:, None, None] + 1.0,
                    (3,) + B).astype(np.float32)
    d = rng.normal(size=(3,) + B).astype(np.float32)
    d[:, 0, :8] = 0.0                                   # axis-parallel and zero
    d[0, 0, 8:16] = -0.0
    active = rng.uniform(size=B) < 0.7
    li = rng.integers(0, 3000, B).astype(np.int32)
    wmin = jnp.asarray(sa.world_min)
    wext = jnp.maximum(jnp.asarray(sa.world_max) - wmin, 1e-6)
    part = _jax_nested("_part1by2")
    morton = _jax_nested("_morton_cell", _part1by2=part, wext_s=wext, wmin_s=wmin)
    jkey = _jax_nested("_spatial_key", _morton_cell=morton)(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(active))
    t = {k: torch.from_numpy(v) for k, v in dict(o=o, d=d, active=active, li=li).items()}
    wext_t = torch.clamp_min(s.world_max - s.world_min, 1e-6)
    key = tint._spatial_key(t["o"], t["d"], t["active"], s.world_min, wext_t)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    assert len(np.unique(key.numpy())) > 100

    seen = {}

    def recorder(tag, xp):
        def any_planar(o3, d3, tmax, excl):
            seen[tag] = [np.asarray(x) for x in (o3, d3, tmax, excl)]
            return o3[0] > float(np.median(o))      # any per-lane function
        return any_planar

    tmax = rng.uniform(0.1, 9.0, B).astype(np.float32)
    excl = rng.integers(0, s.n_tris, B).astype(np.int32)
    jsorted = _jax_nested(
        "_sorted_any", B=B, R_flat=B[0] * B[1], _morton_cell=morton,
        any_planar=recorder("jax", jnp),
    )(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), jnp.asarray(excl),
      jnp.asarray(li), jnp.asarray(active))
    occ = tint._sorted_any(
        recorder("port", torch), t["o"], t["d"], torch.from_numpy(tmax),
        torch.from_numpy(excl), t["li"], t["active"], s.world_min, wext_t)
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jsorted))
    np.testing.assert_array_equal(occ.numpy(), o[0] > float(np.median(o)))

    tint._spatial_key(t["o"], t["d"], t["active"], s.world_min, wext_t, dir_bits=6)
    with pytest.raises(ValueError, match="int32"):
        tint._spatial_key(t["o"], t["d"], t["active"], s.world_min, wext_t, dir_bits=7)


def test_atrium_cluster_render_matches_jax(atrium_scenes):
    """atrium(2_200) through ``intersector cluster`` (the plain K3/K6/K7 on
    the CPU) against the JAX package's render of the same scene (its brute
    oracle), under the module's render bound.  Found: one pixel of 5,184
    outside rtol 1e-3 (a path that an ulp turned), 2.0e-5 mean relative."""
    sa, s = atrium_scenes
    tokens = ["input", "synthetic:atrium:2200", "xres", "96", "yres", "54",
              "samples", "2", "k", "3"] + ATRIUM_CAM
    cfg = RenderConfig.from_tokens(tokens + ["intersector", "cluster", "platform", "cpu"])
    img, stats = render_image(s, cfg, with_stats=True)
    ref, ref_stats = jax_render_image(
        sa, JaxRenderConfig.from_tokens(tokens + ["intersector", "brute"]), with_stats=True)
    ref = np.asarray(ref)
    assert np.median(ref.max(axis=-1)) > 1e-3             # lit hall
    assert_render_close(img.numpy(), ref)
    np.testing.assert_array_equal(stats.numpy(), np.asarray(ref_stats).astype(np.int64))


def test_atrium_cli_matches_golden(tmp_path, capsys):
    """The CLI renders synthetic:atrium:2200 at 160x90, 2 spp, k 2 through
    the cluster path on the CPU; held against tests/golden/atrium_160x90.exr
    (rendered by the JAX package's BVH path) at the golden's own tolerance
    (rtol 2e-3, atol 1e-4, tests/test_self_golden.py) under the module's
    outlier bound."""
    from chiaroscuro_tpu_torch import cli
    from chiaroscuro_tpu_torch.render.image_io import read_exr

    out = tmp_path / "atrium.exr"
    cli.run(
        ["chiaroscuro_tpu_torch", os.path.join(REPO, "scenes", "cornell.rtc"),
         "no-preview", "input", "synthetic:atrium:2200", "intersector", "cluster",
         "platform", "cpu", "xres", "160", "yres", "90", "samples", "2",
         "k", "2", "output", str(out)] + ATRIUM_CAM
    )
    assert "Triangles in scene: 2720" in capsys.readouterr().out
    img = read_exr(str(out))
    golden = jax_read_exr(ATRIUM_GOLDEN)
    assert img.shape == golden.shape == (90, 160, 3)
    outside = ~np.isclose(img, golden, rtol=2e-3, atol=1e-4).all(axis=-1)
    assert outside.mean() <= 0.005, outside.mean()
    assert np.abs(img - golden).mean() <= 1e-3 * golden.mean()
