"""The port's synthetic atrium (scene/synthetic.py) against the JAX
package's: meshes, procedural atlas and every scene field exactly equal, and
the triangle count on budget (ports of tests/test_synthetic.py)."""

import numpy as np
import pytest

from chiaroscuro_tpu.scene import synthetic as jax_synthetic
from chiaroscuro_tpu.scene.config import RenderConfig as JaxRenderConfig
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu.scene.scene_arrays import load_scene as jax_load_scene
from chiaroscuro_tpu_torch.scene import synthetic
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    build_scene_tensors,
    load_scene,
)

MESH_FIELDS = ("positions", "normals", "uvs", "indices", "diffuse", "emissive",
               "ambient", "specular")


@pytest.mark.parametrize("target,seed", [(2_200, 5), (6_000, 3)])
def test_atrium_meshes_equal_jax(target, seed):
    got = synthetic.atrium(target, seed=seed)
    ref = jax_synthetic.atrium(target, seed=seed)
    assert [m.name for m in got] == [m.name for m in ref]
    for m, r in zip(got, ref):
        for f in MESH_FIELDS:
            a, b = getattr(m, f), getattr(r, f)
            assert a.dtype == b.dtype, (m.name, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{m.name}.{f}")
        assert (m.shininess, m.texture_diffuse, m.is_light) == (
            r.shininess, r.texture_diffuse, r.is_light)
    assert synthetic.atrium_tri_count(got) == jax_synthetic.atrium_tri_count(ref)
    assert synthetic.ATRIUM_CAMERA == jax_synthetic.ATRIUM_CAMERA


def test_atrium_deterministic_and_on_budget():
    """tests/test_synthetic.py: the tessellation solves to within ~20% of
    the ask; the emissive panels are the 24 area lights."""
    a = synthetic.atrium(6000, seed=3)
    b = synthetic.atrium(6000, seed=3)
    for ma, mb in zip(a, b):
        np.testing.assert_array_equal(ma.positions, mb.positions)
    for target in (6_000, 40_000):
        got = synthetic.atrium_tri_count(synthetic.atrium(target))
        assert abs(got - target) / target < 0.2, (target, got)
    scene = build_scene_tensors(a, device="cpu")
    assert scene.n_lights == 24
    assert scene.n_tris == synthetic.atrium_tri_count(a)


@pytest.mark.parametrize("kind", ["stone", "plaster", "brick", "wood", "tile"])
def test_proc_textures_equal_jax(kind):
    t = synthetic.proc_texture(f"proc:{kind}:64")
    np.testing.assert_array_equal(t, jax_synthetic.proc_texture(f"proc:{kind}:64"))
    assert t.shape == (64, 64, 3) and t.dtype == np.float32
    assert 0.0 <= t.min() and t.max() <= 1.0 and t.std() > 0.01


def test_proc_texture_bad_paths_raise():
    with pytest.raises(ValueError, match="unknown procedural"):
        synthetic.proc_texture("proc:lava:64")
    with pytest.raises(ValueError, match="not a procedural"):
        synthetic.proc_texture("stone.png")


def test_atrium_scene_fields_equal_jax():
    """Every scene field, the proc: atlas included, equals JAX's exactly."""
    st = build_scene_tensors(synthetic.atrium(2_200, seed=5), device="cpu")
    sa = build_scene_arrays(jax_synthetic.atrium(2_200, seed=5), device_put=False)
    for k in DATA_FIELDS:
        got, ref = getattr(st, k).numpy(), np.asarray(getattr(sa, k))
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    for k in META_FIELDS:
        assert getattr(st, k) == getattr(sa, k), k
    # Textured (tests/test_synthetic.py::test_atrium_is_textured).
    tid = st.tex_id.numpy()
    assert st.tex_data.shape[0] == 5 * 128 * 128 and (tid >= 0).mean() > 0.9
    assert (tid[st.ke.numpy().max(axis=1) > 0] == -1).all()


def test_load_scene_synthetic_equals_jax(capsys):
    tokens = ["input", "synthetic:atrium:2200"]
    st = load_scene(RenderConfig.from_tokens(tokens), "cpu")
    sa = jax_load_scene(JaxRenderConfig.from_tokens(tokens))
    assert "Triangles in scene: 2720" in capsys.readouterr().out
    for k in ("tri_v0", "tex_data", "light_ids", "uv1"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(sa, k)))
    with pytest.raises(ValueError, match="unknown synthetic generator"):
        load_scene(RenderConfig.from_tokens(["input", "synthetic:sponza"]), "cpu")
