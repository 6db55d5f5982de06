"""The port's Phong extension on the CPU: tests/test_specular.py ported,
and the port held against the JAX package on the same scenes.

The renders and gradients run the port's main paths on CPU tensors: the
dense pair (the plain K1/K2) and the cluster pair (the plain K3 and
visits); the JAX side runs its brute oracle, as tests/test_torch_render.py
does.  Scenes come from the JAX package's loaders and are carried into the
port as numpy (``scene_tensors_from_numpy``), or load through each
package's own OBJ loader.

Tolerances, each with its reason:

- Samplers: atol 2e-6 on unit-scale outputs, the diffuse sampler's bound
  (tests/test_torch_sampling.py): XLA and torch evaluate pow, sin, cos and
  rsqrt with different polynomials.  The pdf, at the same directions, is
  held at rtol 2e-5: cos^ns multiplies the dot product's relative rounding
  by ns, up to 200 here.
- Renders: mean |d| <= 1e-4 x mean radiance and at most 0.5% of the
  pixels outside rtol 1e-3 (the bound of tests/test_torch_render.py).  The
  camera sits off the Cornell box's wall edges (``CORNELL_CAMERA``): at
  the edge-on camera of ``cornell_64`` an ulp of XLA's fused CPU
  evaluation turns glossy paths, whereas the port equals JAX's op-by-op
  evaluation there (a Phong wall's zero Kd channel is its specular term
  alone, down to 1e-25).
- Gradients against ``jax.grad``: relative L1 (sum |d| / sum |g_jax|)
  1e-5 for kd, ke and ks, 1e-4 for shininess, whose gradient goes through
  pow's exponent and so carries log(cos) and log(u) factors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.render.renderer import render_image as jax_render_image
from chiaroscuro_tpu.render.renderer import render_samples as jax_render_samples
from chiaroscuro_tpu.sampling import samplers as jsamplers
from chiaroscuro_tpu.scene.builtin import cornell_box as jax_cornell_box
from chiaroscuro_tpu.scene.config import RenderConfig as JaxRenderConfig
from chiaroscuro_tpu.scene.config import LightPoint as JaxLightPoint
from chiaroscuro_tpu.scene.obj_loader import load_obj as jax_load_obj
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu.accel import make_intersectors as jax_make_intersectors
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.render.renderer import render_image, render_samples
from chiaroscuro_tpu_torch.sampling import samplers
from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA, cornell_box
from chiaroscuro_tpu_torch.scene.config import LightPoint, RenderConfig
from chiaroscuro_tpu_torch.scene.obj_loader import Mesh, load_obj
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    BRDF_PHONG,
    DATA_FIELDS,
    META_FIELDS,
    build_scene_tensors,
    params_from_numpy,
    scene_tensors_from_numpy,
)
from test_torch_scene import _textured_obj


def _mesh(name, tris, kd, ke=(0, 0, 0), ks=(0, 0, 0), ns=10.0):
    tris = np.asarray(tris, np.float32)
    positions = tris.reshape(-1, 3)
    normals, indices = [], []
    for i, t in enumerate(tris):
        n = np.cross(t[1] - t[0], t[2] - t[0])
        n = n / np.linalg.norm(n)
        normals += [n, n, n]
        indices.append((3 * i, 3 * i + 1, 3 * i + 2))
    return Mesh(
        name=name, positions=positions,
        normals=np.asarray(normals, np.float32),
        uvs=np.zeros((len(positions), 2), np.float32),
        indices=np.asarray(indices, np.int32),
        diffuse=np.asarray(kd, np.float32),
        emissive=np.asarray(ke, np.float32),
        ambient=np.zeros(3, np.float32),
        specular=np.asarray(ks, np.float32),
        shininess=ns,
    )


FLOOR = dict(
    tris=[
        [(-5, 0, -5), (5, 0, 5), (5, 0, -5)],
        [(-5, 0, -5), (-5, 0, 5), (5, 0, 5)],
    ],
    kd=(0.3, 0.3, 0.3),
)


def _light():
    return _mesh("l:light", [[(-0.4, 4.0, -0.4), (0.4, 4.0, -0.4), (0.0, 4.0, 0.4)]],
                 (1, 1, 1), ke=(30.0, 30.0, 30.0))


def _floor_cfg(**kw):
    return RenderConfig(vp=(0.0, 2.0, 6.0), la=(0.0, 0.0, 0.0), up=(0, 1, 0), yview=0.9,
                        seed=0, intersector="dense", platform="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_specular.py, ported.
# ---------------------------------------------------------------------------


def test_phong_lobe_pdf_normalized():
    """Monte-Carlo check: the lobe's pdf at its own samples is
    (ns+1)/(2pi) cos^ns, and E[cos] = (ns+1)/(ns+2)."""
    rng = np.random.default_rng(1234)
    n = 1 << 14
    ns = torch.full((n,), 20.0)
    wr = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    u = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    v = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    wi, cos_a = samplers.sample_phong_lobe(wr, ns, u, v)
    pdf = samplers.phong_pdf(wr, wi, ns)
    np.testing.assert_allclose(
        pdf.numpy(), (20.0 + 1) / (2 * np.pi) * cos_a.numpy() ** 20.0, rtol=1e-4
    )
    assert np.isclose(cos_a.numpy().mean(), 21.0 / 22.0, atol=0.01)


def test_reflect():
    n = torch.tensor([[0.0, 1.0, 0.0]])
    wo = torch.tensor([[0.6, 0.8, 0.0]])
    np.testing.assert_allclose(samplers.reflect(wo, n).numpy(), [[-0.6, 0.8, 0.0]],
                               atol=1e-6)


def test_specular_disabled_keeps_parity():
    """Without ``enable_specular`` no triangle is Phong, and a render with
    every Ks set is bitwise the render with none (the reference-exact
    branch)."""
    meshes = cornell_box()
    plain = build_scene_tensors(meshes, device="cpu")
    for m in meshes:
        m.specular = np.asarray([0.5, 0.5, 0.5], np.float32)
    glossy_off = build_scene_tensors(meshes, device="cpu")
    assert not glossy_off.has_specular
    assert not (glossy_off.brdf_type == BRDF_PHONG).any()
    cam = CORNELL_CAMERA
    cfg = RenderConfig(xres=8, yres=8, k=3, samples=2, vp=cam["eye"], la=cam["center"],
                       up=cam["up"], yview=cam["yview"], intersector="dense", platform="cpu")
    assert torch.equal(render_image(glossy_off, cfg), render_image(plain, cfg))


def test_specular_adds_highlight():
    """A glossy floor under a light shows a stronger peak toward the mirror
    direction than a pure-diffuse floor."""
    cfg = _floor_cfg(xres=32, yres=32, k=1, samples=64)
    diffuse = build_scene_tensors([_mesh("f:d", **FLOOR), _light()],
                                  enable_specular=True, device="cpu")
    glossy = build_scene_tensors([_mesh("f:s", ks=(0.6, 0.6, 0.6), ns=50.0, **FLOOR), _light()],
                                 enable_specular=True, device="cpu")
    assert glossy.has_specular and not diffuse.has_specular
    img_d = render_image(diffuse, cfg).numpy()
    img_s = render_image(glossy, cfg).numpy()
    assert np.isfinite(img_s).all()
    assert img_s.max() > 2.0 * img_d.max()


def test_specular_gradients_finite_and_fd():
    """d(loss)/d(Ks) is finite and matches central finite differences
    (tests/test_specular.py's bound, rtol 0.05)."""
    scene = build_scene_tensors(
        [_mesh("f:s", ks=(0.5, 0.5, 0.5), ns=30.0, **FLOOR), _light()],
        enable_specular=True, device="cpu",
    )
    cfg = _floor_cfg(xres=12, yres=12, k=2, samples=16)

    def loss(ks):
        return render_image(scene.replace(ks=ks), cfg).mean()

    ks = scene.ks.clone().requires_grad_()
    loss(ks).backward()
    g = ks.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    eps = 1e-3

    def perturb(d):
        arr = scene.ks.numpy().copy()
        arr[0, 0] += d
        with torch.no_grad():
            return float(loss(torch.from_numpy(arr)))

    fd = (perturb(eps) - perturb(-eps)) / (2 * eps)
    assert np.isclose(g[0, 0], fd, rtol=0.05), (g[0, 0], fd)


# ---------------------------------------------------------------------------
# The samplers against the JAX package's.
# ---------------------------------------------------------------------------


def _sampler_inputs():
    rng = np.random.default_rng(7)
    R = 4096
    wr = rng.normal(size=(R, 3)).astype(np.float32)
    wr /= np.linalg.norm(wr, axis=1, keepdims=True)
    wr[:4] = [[1, 0, 0], [0, 1, 0], [0, 0, -1], [0.6, -0.8, 0]]   # axis-aligned frames
    wo = rng.normal(size=(R, 3)).astype(np.float32)
    ns = rng.uniform(1.0, 200.0, R).astype(np.float32)
    u = rng.uniform(size=R).astype(np.float32)
    v = rng.uniform(size=R).astype(np.float32)
    u[:2] = [0.0, np.float32(1.0 - 2.0**-24)]
    return wr, wo, ns, u, v


@pytest.mark.parametrize("layout", ["planar", "rows"])
def test_phong_samplers_match_jax(layout):
    """reflect, the lobe sample and its pdf, row-major and planar, against
    the JAX package's on the same inputs (module docstring's bounds)."""
    wr, wo, ns, u, v = _sampler_inputs()
    t = {k: torch.from_numpy(x) for k, x in dict(wr=wr, wo=wo, ns=ns, u=u, v=v).items()}
    if layout == "rows":
        got = (samplers.reflect(t["wo"], t["wr"]),
               *samplers.sample_phong_lobe(t["wr"], t["ns"], t["u"], t["v"]))
        ref = (jsamplers.reflect(wo, wr), *jsamplers.sample_phong_lobe(wr, ns, u, v))
        wi = np.array(ref[1])
        pdf = samplers.phong_pdf(t["wr"], torch.from_numpy(wi), t["ns"])
        ref_pdf = jsamplers.phong_pdf(wr, wi, ns)
        got = [x.numpy() for x in got]
        ref = [np.asarray(x) for x in ref]
    else:
        got = (samplers.reflect_planar(t["wo"].T, t["wr"].T),
               *samplers.sample_phong_lobe_planar(t["wr"].T, t["ns"], t["u"], t["v"]))
        ref = (jsamplers.reflect_planar(wo.T, wr.T),
               *jsamplers.sample_phong_lobe_planar(wr.T, ns, u, v))
        wi = np.array(ref[1])
        pdf = samplers.phong_pdf_planar(t["wr"].T, torch.from_numpy(wi), t["ns"])
        ref_pdf = jsamplers.phong_pdf_planar(wr.T, wi, ns)
        got = [x.numpy() for x in got]
        ref = [np.asarray(x) for x in ref]
    for name, a, b in zip(("reflect", "wi", "cos_a"), got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6, err_msg=name)
    # The pdf of both packages at JAX's wi.
    np.testing.assert_allclose(pdf.numpy(), np.asarray(ref_pdf), rtol=2e-5, atol=1e-30)


# ---------------------------------------------------------------------------
# Phong renders against the JAX package's.
# ---------------------------------------------------------------------------


def _glossy_blocks(module):
    """The builtin Cornell box with Ks 0.5 and Ns 50 on its two blocks."""
    meshes = module()
    for m in meshes:
        if "block" in m.name:
            m.specular = np.asarray([0.5, 0.5, 0.5], np.float32)
            m.shininess = 50.0
    return meshes


def _glossy_textured_obj(tmp_path):
    """``_textured_obj``'s floor made glossy with a specular map."""
    from PIL import Image

    path = _textured_obj(tmp_path)
    rng = np.random.default_rng(6)
    Image.fromarray(rng.integers(0, 255, (3, 5, 3), dtype=np.uint8)).save(
        tmp_path / "spec.png")
    mtl = (tmp_path / "s.mtl").read_text()
    (tmp_path / "s.mtl").write_text(
        mtl.replace("map_Kd tex.png\n", "map_Kd tex.png\nKs 0.4 0.4 0.4\nNs 30\nmap_Ks spec.png\n"))
    return path


def _port_scene(sa):
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    return scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")


def assert_render_close(img, ref):
    """The bound stated in the module docstring."""
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert np.abs(img - ref).mean() <= 1e-4 * ref.mean()
    outside = ~np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    assert outside.mean() <= 0.005, outside.mean()


@pytest.mark.parametrize("method", ["dense", "cluster"])
@pytest.mark.parametrize("scene_name", ["cornell_blocks", "textured_obj"])
def test_phong_render_matches_jax(scene_name, method, tmp_path):
    """A Phong scene through the port's dense and cluster plain paths
    against the JAX render of the same scene (its brute oracle), under the
    module's render bound: the Cornell box with glossy blocks, and
    ``_textured_obj`` with a glossy floor whose Ks comes from a map_Ks
    texture, lit by its lamp and its point light.  Specular must change the
    image."""
    if scene_name == "cornell_blocks":
        cam = CORNELL_CAMERA
        tokens = ["input", "builtin:cornell_box", "xres", "32", "yres", "32", "samples", "4",
                  "k", "4", "VP", *map(str, cam["eye"]), "LA", *map(str, cam["center"]),
                  "UP", *map(str, cam["up"]), "yview", str(cam["yview"])]
        sa = build_scene_arrays(_glossy_blocks(jax_cornell_box), enable_specular=True)
        scene = _port_scene(sa)
        diffuse = build_scene_tensors(cornell_box(), device="cpu")
    else:
        path = _glossy_textured_obj(tmp_path)
        pls = [((0.0, 1.5, 0.0), (255.0, 128.0, 0.0), 2.0)]
        tokens = ["input", path, "xres", "32", "yres", "24", "samples", "4", "k", "3",
                  "VP", "0", "1.2", "2.6", "LA", "0", "0.2", "0", "UP", "0", "1", "0",
                  "yview", "1.0"]
        scene = build_scene_tensors(load_obj(path), enable_specular=True,
                                    point_lights=[LightPoint(*p) for p in pls], device="cpu")
        sa = build_scene_arrays(jax_load_obj(path), enable_specular=True,
                                point_lights=[JaxLightPoint(*p) for p in pls])
        assert int((scene.tex_id_ks >= 0).sum()) == 2
        diffuse = build_scene_tensors(load_obj(path), point_lights=[LightPoint(*p) for p in pls],
                                      device="cpu")
    assert scene.has_specular and sa.has_specular
    cfg = RenderConfig.from_tokens(tokens + ["intersector", method, "platform", "cpu"])
    img = render_image(scene, cfg).numpy()
    ref = np.asarray(jax_render_image(sa, JaxRenderConfig.from_tokens(
        tokens + ["intersector", "brute"])))
    assert ref.mean() > 1e-3
    assert_render_close(img, ref)
    plain = render_image(diffuse, cfg).numpy()
    assert np.abs(img - plain).mean() > 1e-3 * img.mean()


# ---------------------------------------------------------------------------
# Gradients against jax.grad.
# ---------------------------------------------------------------------------

GRAD_FIELDS = ("kd", "ke", "ks", "shininess")
GRAD_RES = (16, 16)


def _grad_loss_weights():
    return np.linspace(0.5, 1.5, GRAD_RES[0] * GRAD_RES[1] * 3, dtype=np.float32).reshape(-1, 3)


def _pixels():
    ys, xs = np.meshgrid(np.arange(GRAD_RES[1]), np.arange(GRAD_RES[0]), indexing="ij")
    return xs.reshape(-1).astype(np.int32), ys.reshape(-1).astype(np.int32)


@pytest.fixture(scope="module")
def phong_grads_jax():
    """The glossy-blocks Cornell scene and ``jax.grad`` of the weighted
    mean of its 16x16 x 2 spp x k 3 render through JAX's brute oracle."""
    sa = build_scene_arrays(_glossy_blocks(jax_cornell_box), enable_specular=True)
    cam = CORNELL_CAMERA
    px, py = _pixels()
    w = _grad_loss_weights()

    def jloss(params):
        s = dataclasses.replace(sa, **params)
        cf, af = jax_make_intersectors(s, "brute")
        img = jax_render_samples(
            s, jnp.asarray(cam["eye"], jnp.float32), jnp.asarray(cam["center"], jnp.float32),
            jnp.asarray(cam["up"], jnp.float32), jnp.float32(cam["yview"]), *GRAD_RES,
            jnp.asarray(px), jnp.asarray(py), jnp.int32(0), 2, jnp.uint32(0), 3,
            jnp.zeros(3, jnp.float32), cf, af)
        return jnp.mean(img * w)

    ref = jax.grad(jloss)({k: getattr(sa, k) for k in GRAD_FIELDS})
    return sa, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("method", ["dense", "cluster"])
def test_phong_gradients_match_jax(method, phong_grads_jax):
    """Gradients of a weighted mean of a Phong Cornell render (glossy
    blocks, 16x16 x 2 spp x k 3) w.r.t. kd, ke, ks and shininess through
    the port's dense (plain K1 in the closest-hit Function) and cluster
    (plain K4) paths against ``jax.grad`` of the same loss through JAX's
    brute oracle, under the module's bounds; every gradient finite, and ks
    and shininess non-zero on the glossy blocks only.  Found, the same on
    both paths: relative L1 kd 1.3e-7, ke 4.0e-8, ks 4.5e-7, shininess
    4.0e-6."""
    sa, ref = phong_grads_jax
    cam = CORNELL_CAMERA
    px, py = _pixels()
    w = _grad_loss_weights()
    scene = _port_scene(sa)
    params = params_from_numpy({k: np.asarray(getattr(sa, k)) for k in GRAD_FIELDS}, "cpu")
    s = scene.replace(**params)
    cf, af = make_intersectors(s, method)
    img = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], *GRAD_RES,
                         torch.from_numpy(px), torch.from_numpy(py), 0, 2, 0, 3,
                         (0.0, 0.0, 0.0), cf, af)
    (img * torch.from_numpy(w)).mean().backward()
    phong = (scene.brdf_type == BRDF_PHONG).numpy()
    for k, bound in (("kd", 1e-5), ("ke", 1e-5), ("ks", 1e-5), ("shininess", 1e-4)):
        g = params[k].grad.numpy()
        assert np.isfinite(g).all(), k
        rel = np.abs(g - ref[k]).sum() / np.abs(ref[k]).sum()
        assert rel <= bound, (k, rel)
    for k in ("ks", "shininess"):
        g = params[k].grad.numpy().reshape(len(phong), -1)
        assert np.abs(g[phong]).sum() > 0 and not g[~phong].any(), k
