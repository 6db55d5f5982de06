"""The port's preview (``chiaroscuro_tpu_torch/preview/``) on the CPU: the
headless cases of tests/test_preview.py on the port's copies of the fly
camera and the input state machine, the raster frame against the JAX
package's ``raster_frame`` through each intersector branch, and the CLI
without ``no-preview``.

Raster tolerance: rtol 1e-5, atol 1e-6, with ids held equal through the
intersectors' own tolerances (the JAX side runs its Pallas kernels in
interpret mode).  The frame is one hit a pixel shaded by a few normalizes, a
``pow`` and products: XLA contracts products into FMAs on the CPU and takes
its own rsqrt, torch rounds each op (found: 2.4e-7 largest absolute
difference, 3.8e-7 relative, on Cornell; 6.0e-8 on the atrium).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from chiaroscuro_tpu.accel.clusters import build_clusters as jax_build_clusters
from chiaroscuro_tpu.accel.dispatch import make_intersectors as jax_make_intersectors
from chiaroscuro_tpu.geometry.camera import camera_basis as jax_camera_basis
from chiaroscuro_tpu.ops.cluster_pallas import (
    make_cluster_intersectors as jax_make_cluster_intersectors,
)
from chiaroscuro_tpu.ops.intersect_pallas import make_pallas_intersectors
from chiaroscuro_tpu.preview.flycam import FlyCamera as JaxFlyCamera
from chiaroscuro_tpu.preview.raster import raster_frame as jax_raster_frame
from chiaroscuro_tpu.scene.builtin import cornell_box as jax_cornell_box
from chiaroscuro_tpu.scene.config import RenderConfig as JaxRenderConfig
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu.scene.synthetic import atrium as jax_atrium
from chiaroscuro_tpu_torch import cli
from chiaroscuro_tpu_torch.accel.clusters import cluster_arrays_from_numpy
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.geometry.camera import camera_basis
from chiaroscuro_tpu_torch.preview import flycam
from chiaroscuro_tpu_torch.preview.flycam import FlyCamera, yview_to_zoom, zoom_to_yview
from chiaroscuro_tpu_torch.preview.raster import raster_frame
from chiaroscuro_tpu_torch.preview.state import PreviewState
from chiaroscuro_tpu_torch.preview.viewer import make_state
from chiaroscuro_tpu_torch.render.renderer import Renderer
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    scene_tensors_from_numpy,
)
from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_scene(sa):
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    return scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")


# ---------------------------------------------------------------------------
# FlyCamera (tests/test_preview.py, on the port's copy)
# ---------------------------------------------------------------------------


def test_seeded_camera_faces_look_at():
    eye = np.array([1.0, 2.0, 3.0])
    la = np.array([-2.0, 0.5, -4.0])
    cam = FlyCamera(eye, la, (0, 1, 0))
    want = (la - eye) / np.linalg.norm(la - eye)
    np.testing.assert_allclose(cam.front, want, atol=1e-12)


def test_zoom_yview_roundtrip():
    for yv in (0.5, 1.0, 1.8):
        assert zoom_to_yview(yview_to_zoom(yv)) == pytest.approx(yv, rel=1e-12)
    cam = FlyCamera((0, 0, 2), (0, 0, 0), (0, 1, 0), yview=1.25)
    assert cam.yview == pytest.approx(1.25, rel=1e-12)
    assert cam.zoom == pytest.approx(np.degrees(2 * np.arctan(0.625)))


def test_render_args_match_reference_basis():
    """R before moving re-renders the scene's own view: the port's basis from
    the camera's render_args equals the JAX package's from (VP, LA, UP)."""
    vp, la, up, yv = (0.2, 1.0, 3.9), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0), 1.0
    cam = FlyCamera(vp, la, up, yview=yv)
    eye, center, cup, yview = cam.render_args()
    ref = jax_camera_basis(jnp.asarray(vp), jnp.asarray(la), jnp.asarray(up), yv, 64, 64)
    got = camera_basis(eye, center, cup, yview, 64, 64)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
    jcam = JaxFlyCamera(vp, la, up, yview=yv)
    for a, b in zip(jcam.render_args(), cam.render_args()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mouse_look_sensitivity_and_pitch_clamp():
    cam = FlyCamera((0, 0, 2), (0, 0, 0), (0, 1, 0))
    yaw0, pitch0 = cam.yaw, cam.pitch
    cam.process_mouse_movement(100.0, 50.0)
    assert cam.yaw == pytest.approx(yaw0 + 10.0)
    assert cam.pitch == pytest.approx(pitch0 + 5.0)
    cam.process_mouse_movement(0.0, 1e6)
    assert cam.pitch == 89.0
    cam.process_mouse_movement(0.0, -1e7)
    assert cam.pitch == -89.0
    assert np.isfinite(cam.front).all()


def test_scroll_zoom_clamps_1_to_90():
    cam = FlyCamera((0, 0, 2), (0, 0, 0), (0, 1, 0), yview=1.0)
    cam.process_mouse_scroll(1000.0)
    assert cam.zoom == 1.0
    cam.process_mouse_scroll(-1000.0)
    assert cam.zoom == 90.0
    assert cam.yview == pytest.approx(2.0 * np.tan(np.radians(45.0)))


def test_keyboard_motion_signs():
    cam = FlyCamera((0, 0, 0), (0, 0, -1), (0, 1, 0))
    cam.process_keyboard(flycam.FORWARD, 1.0)
    np.testing.assert_allclose(cam.position, cam.front * flycam.SPEED, atol=1e-12)
    cam2 = FlyCamera((0, 0, 0), (0, 0, -1), (0, 1, 0))
    cam2.process_keyboard(flycam.UPWARD, 1.0)     # reference quirk: against Up
    assert float(cam2.position @ cam2.up) < 0.0


# ---------------------------------------------------------------------------
# PreviewState (stub renderer, as tests/test_preview.py)
# ---------------------------------------------------------------------------


class _StubCfg:
    vp, la, up, yview = (0.0, 0.0, 2.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 1.0
    exposure = 5.0
    xres = yres = 8


class _StubRenderer:
    def __init__(self):
        self.cfg = _StubCfg()
        self.ray_trace_calls = []
        self.normalize_calls = []

    def ray_trace(self, eye, center, up, yview):
        self.ray_trace_calls.append((tuple(eye), tuple(center), tuple(up), yview))
        return np.zeros((8, 8, 3), np.float32)

    def normalize_image(self, exposure):
        self.normalize_calls.append(exposure)
        return np.full((8, 8, 3), 128, np.uint8)


def test_press_r_renders_and_shows():
    r = _StubRenderer()
    st = PreviewState(r)
    assert not st.show_render
    st.press_r()
    assert st.show_render and len(r.ray_trace_calls) == 1
    st.press_r()
    assert r.ray_trace_calls[0] == r.ray_trace_calls[1]
    assert (st.display_image() == 128).all()


def test_exposure_retonemaps_without_tracing():
    r = _StubRenderer()
    st = PreviewState(r)
    st.press_r()
    n_trace = len(r.ray_trace_calls)
    st.adjust_exposure(+0.2)
    st.adjust_exposure(-0.2)
    assert len(r.ray_trace_calls) == n_trace
    assert r.normalize_calls[-2:] == [pytest.approx(5.2), pytest.approx(5.0)]


def test_inputs_inert_while_render_shown():
    r = _StubRenderer()
    st = PreviewState(r)
    st.press_r()
    pos0, yaw0, zoom0 = st.camera.position.copy(), st.camera.yaw, st.camera.zoom
    assert not st.mouse_move(50.0, 0.0)
    assert not st.scroll(1.0)
    assert not st.move_key("w", 0.1)
    assert st.camera.yaw == yaw0 and st.camera.zoom == zoom0
    np.testing.assert_array_equal(st.camera.position, pos0)
    st.press_tab()
    assert st.mouse_move(50.0, 0.0) and st.scroll(1.0) and st.move_key("w", 0.1)


def test_tab_toggles_and_moving_resets_after_rerender():
    r = _StubRenderer()
    st = PreviewState(r)
    st.press_r()
    st.press_tab()
    assert not st.show_render
    st.move_key("w", 0.5)
    st.press_r()
    assert r.ray_trace_calls[0] != r.ray_trace_calls[-1]


def test_shift_is_fast():
    st = PreviewState(_StubRenderer())
    start = st.camera.position.copy()
    st.move_key("w", 1.0, fast=False)
    slow = np.linalg.norm(st.camera.position - start)
    st2 = PreviewState(_StubRenderer())
    st2.move_key("w", 1.0, fast=True)
    fast = np.linalg.norm(st2.camera.position - start)
    assert fast == pytest.approx(slow * flycam.FAST_SPEED / flycam.SPEED)


def test_raster_fallback_black_and_fn_wiring():
    r = _StubRenderer()
    st = PreviewState(r)
    assert (st.display_image() == 0).all()
    frames = []

    def raster(cam):
        frames.append(cam.position.copy())
        return np.full((8, 8, 3), 0.5, np.float32)

    st2 = PreviewState(r, raster_fn=raster)
    img = st2.display_image()
    assert img.dtype == np.uint8 and img.max() == 128
    st2.display_image()
    assert len(frames) == 1
    st2.move_key("w", 0.1)
    st2.display_image()
    assert len(frames) == 2


# ---------------------------------------------------------------------------
# The raster frame against the JAX package's.
# ---------------------------------------------------------------------------


def _cornell_pairs(method):
    sa = build_scene_arrays(jax_cornell_box())
    if method == "dense":
        jpair = make_pallas_intersectors(sa, interpret=True)
    else:
        jpair = jax_make_intersectors(sa, method)
    return sa, jpair, make_intersectors(_port_scene(sa), method)


def _atrium_cluster_pairs():
    sa = build_scene_arrays(jax_atrium(2_200))
    jca = jax_build_clusters(np.asarray(sa.tri_v0), np.asarray(sa.tri_v1),
                             np.asarray(sa.tri_v2), 32)
    import dataclasses

    ca = cluster_arrays_from_numpy(dataclasses.asdict(jca))
    jpair = jax_make_cluster_intersectors(sa, M=32, interpret=True, stream=False, clusters=jca)
    return sa, jpair, make_intersectors(_port_scene(sa), "cluster", clusters=ca)


@pytest.mark.parametrize("case", ["cornell_brute", "cornell_dense", "cornell_bvh",
                                  "atrium_cluster"])
def test_raster_frame_matches_jax(case):
    """``raster_frame`` through every pair's ``.planar_fn`` (brute and BVH
    through ``intersect_cuda.planar_pair``, dense K1, cluster K4) against
    the JAX package's, 32x24, at the module's tolerance."""
    if case == "atrium_cluster":
        sa, jpair, pair = _atrium_cluster_pairs()
        cam = ATRIUM_CAMERA
        view = dict(vp=cam["eye"], la=cam["center"], up=cam["up"], yview=cam["yview"])
    else:
        sa, jpair, pair = _cornell_pairs(case.split("_")[1])
        view = dict(vp=(278.0, 273.0, -800.0), la=(278.0, 273.0, 0.0), up=(0.0, 1.0, 0.0),
                    yview=0.7)
    jcfg = JaxRenderConfig(xres=32, yres=24, **view)
    cfg = RenderConfig(xres=32, yres=24, platform="cpu", **view)
    assert callable(pair[0].planar_fn) and callable(pair[1].planar_fn)
    ref = jax_raster_frame(sa, jcfg, JaxFlyCamera(jcfg.vp, jcfg.la, jcfg.up, jcfg.yview),
                           jpair[0])
    scene = _port_scene(sa)
    img = raster_frame(scene, cfg, FlyCamera(cfg.vp, cfg.la, cfg.up, cfg.yview), pair[0])
    assert img.shape == (24, 32, 3) and img.dtype == np.float32
    assert (img.sum(axis=-1) > 0).mean() > 0.5 and img.std() > 0.01
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)


def test_make_state_drives_a_renderer():
    """``make_state`` wires the raster frame of the renderer's own
    intersector into the state machine: the walk-through frame, then R (a
    progressive layer) and the tone-mapped render."""
    cfg = RenderConfig.from_tokens(["input", "builtin:cornell_box", "xres", "16", "yres", "12",
                                    "samples", "1", "k", "2", "platform", "cpu",
                                    "intersector", "bvh"])
    r = Renderer(_port_scene(build_scene_arrays(jax_cornell_box())), cfg)
    st = make_state(r)
    walk = st.display_image()
    assert walk.shape == (12, 16, 3) and walk.dtype == np.uint8 and walk.max() > 0
    st.press_r()
    shown = st.display_image()
    assert shown.shape == (12, 16, 3) and r._layers == 1 and np.isfinite(r.pixels).all()
    st.press_tab()
    np.testing.assert_array_equal(st.display_image(), walk)


# ---------------------------------------------------------------------------
# The CLI without no-preview.
# ---------------------------------------------------------------------------

CLI_TOKENS = ["input", "builtin:cornell_box", "xres", "16", "yres", "12", "samples", "2",
              "k", "2", "platform", "cpu"]


def test_cli_preview_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib is missing (the card's host has none) the preview
    renders one layer, says so, and the CLI exports it."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "c.exr"
    r = cli.run(["chiaroscuro_tpu_torch", "scenes/cornell.rtc", *CLI_TOKENS,
                 "output", str(out)])
    assert "No interactive backend available; rendering one layer instead." in \
        capsys.readouterr().out
    assert out.exists() and r._layers == 1 and float(r.pixels.mean()) > 0.0


def test_cli_preview_headless(tmp_path):
    """Without a display the interactive backend cannot load: the preview
    renders one layer and the CLI exports, in a fresh process."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("DISPLAY", "WAYLAND_DISPLAY", "MPLBACKEND", "PYTHONPATH")}
    out = tmp_path / "c.png"
    proc = subprocess.run(
        [sys.executable, "-m", "chiaroscuro_tpu_torch", "scenes/cornell.rtc", *CLI_TOKENS,
         "output", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "rendering one layer instead" in proc.stdout
    assert "Render succesfully saved" in proc.stdout and out.exists()
