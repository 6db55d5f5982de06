"""Scene side of the port against the JAX package: config parsing, scene
flattening (exact, field by field) and the numpy bridge."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from chiaroscuro_tpu.render.renderer import render_image as jax_render_image
from chiaroscuro_tpu.scene import builtin as jax_builtin
from chiaroscuro_tpu.scene.config import RenderConfig as JaxRenderConfig
from chiaroscuro_tpu.scene.config import LightPoint as JaxLightPoint
from chiaroscuro_tpu.scene.obj_loader import load_obj as jax_load_obj
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu_torch.render.renderer import render_image
from chiaroscuro_tpu_torch.scene import builtin
from chiaroscuro_tpu_torch.scene.config import LightPoint, RenderConfig
from chiaroscuro_tpu_torch.scene.obj_loader import load_obj
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    build_scene_tensors,
    load_scene,
    scene_tensors_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL_RTC = os.path.join(REPO, "scenes", "cornell.rtc")


@pytest.mark.parametrize("extra", [
    [],
    ["xres", "64", "samples", "8", "no-preview", "seed", "7", "k", "3"],
    ["VP", "1", "2", "3", "spp-chunk", "4", "intersector", "brute", "bogus"],
])
def test_config_matches_jax_parse(extra):
    """Same .rtc plus CLI overrides -> the same fields (last wins).  The one
    intended difference: ``platform`` defaults to "cuda" in the port."""
    cfg = RenderConfig.from_rtc(CORNELL_RTC, extra + ["platform", "cpu"])
    ref = JaxRenderConfig.from_rtc(CORNELL_RTC, extra + ["platform", "cpu"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert RenderConfig.from_rtc(CORNELL_RTC, extra).platform == "cuda"


def test_legacy_rtc_with_point_lights_matches_jax(tmp_path):
    path = tmp_path / "legacy.rtc"
    path.write_text(
        "scene.obj\nout.png\n2\n40 30\n0 1 3\n0 1 0\n0 1 0\n1.0\n"
        "L 0 1.8 0 255 200 100 3.5\n"
    )
    cfg = RenderConfig.from_rtc(str(path), ["samples", "2", "platform", "cpu"])
    ref = JaxRenderConfig.from_rtc(str(path), ["samples", "2", "platform", "cpu"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert len(cfg.light_points) == 1


def _textured_obj(tmp_path):
    """A floor quad with a texture and a lamp quad, as OBJ + MTL + PNG."""
    from PIL import Image

    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 255, (4, 6, 3), dtype=np.uint8)).save(
        tmp_path / "tex.png"
    )
    (tmp_path / "s.mtl").write_text(
        "newmtl floor\nKd 0.7 0.6 0.5\nmap_Kd tex.png\n"
        "newmtl lamp\nKd 0 0 0\nKe 5 5 4\n"
    )
    (tmp_path / "s.obj").write_text(
        "mtllib s.mtl\n"
        "v -1 0 -1\nv 1 0 -1\nv 1 0 1\nv -1 0 1\n"
        "v -0.2 1.9 -0.2\nv 0.2 1.9 -0.2\nv 0.2 1.9 0.2\nv -0.2 1.9 0.2\n"
        "vt 0 0\nvt 2 0\nvt 2 2\nvt 0 2\n"
        "o floor\nusemtl floor\nf 1/1 4/4 3/3 2/2\n"
        "o lamp\nusemtl lamp\nf 5 6 7 8\n"
    )
    return str(tmp_path / "s.obj")


SCENES = ["cornell_box", "cornell_box_original", "textured_obj"]


def _both(name, tmp_path):
    if name == "textured_obj":
        path = _textured_obj(tmp_path)
        pls = [((0.0, 1.5, 0.0), (255.0, 128.0, 0.0), 2.0)]
        return (
            build_scene_tensors(
                load_obj(path), point_lights=[LightPoint(*p) for p in pls],
                device="cpu",
            ),
            build_scene_arrays(
                jax_load_obj(path), point_lights=[JaxLightPoint(*p) for p in pls]
            ),
        )
    return (
        build_scene_tensors(getattr(builtin, name)(), device="cpu"),
        build_scene_arrays(getattr(jax_builtin, name)()),
    )


@pytest.mark.parametrize("name", SCENES)
def test_scene_tensors_equal_scene_arrays(name, tmp_path):
    """Exact: same values, same dtypes, same static fields."""
    st, sa = _both(name, tmp_path)
    for k in DATA_FIELDS:
        got = getattr(st, k).numpy()
        ref = np.asarray(getattr(sa, k))
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    for k in META_FIELDS:
        assert getattr(st, k) == getattr(sa, k), k
    if name == "textured_obj":
        assert st.tex_data.shape[0] == 24 and st.n_point_lights == 1


def test_scene_tensors_from_numpy_round_trips():
    st = build_scene_tensors(builtin.cornell_box(), device="cpu")
    fields = {k: getattr(st, k).numpy() for k in DATA_FIELDS}
    meta = {k: getattr(st, k) for k in META_FIELDS}
    back = scene_tensors_from_numpy(fields, meta, "cpu")
    for k in DATA_FIELDS:
        assert torch.equal(getattr(back, k), getattr(st, k)), k
    assert {k: getattr(back, k) for k in META_FIELDS} == meta
    assert back.device == torch.device("cpu")


def test_load_scene_builtin_and_unported_inputs(capsys):
    cfg = RenderConfig.from_tokens(["input", "builtin:cornell_box"])
    scene = load_scene(cfg, "cpu")
    assert scene.n_tris == 36 and scene.n_lights == 2
    assert "Triangles in scene: 36" in capsys.readouterr().out
    # synthetic: inputs load as the JAX package loads them.
    from chiaroscuro_tpu.scene.scene_arrays import load_scene as jax_load_scene

    tokens = ["input", "synthetic:atrium:2200"]
    st = load_scene(RenderConfig.from_tokens(tokens), "cpu")
    sa = jax_load_scene(JaxRenderConfig.from_tokens(tokens))
    for k in DATA_FIELDS:
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(sa, k)), err_msg=k)
    assert st.n_tris == sa.n_tris == 2720 and st.n_lights == 24


@pytest.mark.parametrize("method", ["dense", "cluster"])
@pytest.mark.parametrize("point_lights", ["on", "off"])
def test_point_light_render_matches_jax(tmp_path, method, point_lights):
    """``_textured_obj`` lit by its lamp quad and, with ``point-lights on``,
    by its point light (the integrator's point-light loop, which no other
    port test renders), through the port's ``dense`` and ``cluster`` plain
    versions against the JAX render of the same scene (its brute oracle).
    Bound (tests/test_torch_render.py): mean |d| <= 1e-4 x mean radiance
    and at most 0.5% of the pixels outside rtol 1e-3.  The point light
    must change the image."""
    path = _textured_obj(tmp_path)
    pls = [((0.0, 1.5, 0.0), (255.0, 128.0, 0.0), 2.0)]
    tokens = ["input", path, "xres", "32", "yres", "24", "samples", "2", "k", "2",
              "VP", "0", "1.2", "2.6", "LA", "0", "0.2", "0", "UP", "0", "1", "0",
              "yview", "1.0", "point-lights", point_lights]
    cfg = RenderConfig.from_tokens(tokens + ["intersector", method, "platform", "cpu"])
    lights = [LightPoint(*p) for p in pls] if cfg.use_point_lights else ()
    scene = build_scene_tensors(load_obj(path), point_lights=lights, device="cpu")
    assert scene.n_point_lights == (point_lights == "on")
    img = render_image(scene, cfg).numpy()
    jcfg = JaxRenderConfig.from_tokens(tokens + ["intersector", "brute"])
    jlights = [JaxLightPoint(*p) for p in pls] if jcfg.use_point_lights else ()
    ref = np.asarray(jax_render_image(
        build_scene_arrays(jax_load_obj(path), point_lights=jlights), jcfg))
    assert img.shape == ref.shape == (24, 32, 3) and np.isfinite(img).all()
    assert ref.mean() > 1e-3
    assert np.abs(img - ref).mean() <= 1e-4 * ref.mean()
    outside = ~np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    assert outside.mean() <= 0.005, outside.mean()
    if point_lights == "on":
        dark = build_scene_tensors(load_obj(path), device="cpu")
        assert np.abs(img - render_image(dark, cfg).numpy()).mean() > 1e-3 * img.mean()
