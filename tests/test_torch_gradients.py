"""The port's gradients on the CPU: tests/test_gradients.py ported, and the
port's gradients held against ``jax.grad`` of the same loss.

The losses follow the JAX tests: substitute parameters into the scene
(``SceneTensors.replace``, the counterpart of ``dataclasses.replace``),
rebuild the intersectors from the substituted scene, render, reduce.  The
port runs its main paths: the dense K1 path (``intersector dense``; on CPU
tensors the kernel's plain version inside the closest-hit
``autograd.Function``) and the cluster path (the plain K4/K6 visits inside
the same Function).  Parameters are made with numpy (a JAX ``SceneArrays``
read out) and carried across with ``params_from_numpy``.

Not ported: ``test_bwd_onehot_fetch_matches_gather`` (test_gradients.py:252).
It holds the TPU-only one-hot MXU fetch of the JAX backward against its
gather; the port's backward has only the gather (``_recompute_hit``), so
there is nothing to compare.

Tolerances, each with its reason:

- Finite differences (the ported cases): the JAX tests' own bounds.
- Port against ``jax.grad`` on the same inputs: rtol 1e-4 with an atol of
  1e-5 x the largest gradient entry.  Both packages run the same estimator
  on the same Threefry streams, but XLA contracts products into FMAs on the
  CPU and torch rounds each op (ROADMAP section 3), so the forward values
  agree to a few ulps and the per-entry gradient sums, accumulated in
  different orders over thousands of paths, to ~1e-6 relative.  The camera
  sits off the degenerate wall edge (CORNELL_CAMERA, the atrium's own view),
  where an ulp would turn paths.  Found: see each test.
- Cluster against brute (tests/test_cluster.py:196-242): rtol 2e-3,
  atol 1e-6, that test's bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.accel.clusters import build_clusters as jax_build_clusters
from chiaroscuro_tpu.ops.cluster_pallas import (
    make_cluster_intersectors as jax_make_cluster_intersectors,
)
from chiaroscuro_tpu.ops.intersect_pallas import make_pallas_intersectors
from chiaroscuro_tpu.render.renderer import render_samples as jax_render_samples
from chiaroscuro_tpu.scene.builtin import cornell_box as jax_cornell_box
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu.scene.synthetic import atrium as jax_atrium
from chiaroscuro_tpu_torch.accel.clusters import cluster_arrays_from_numpy
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
from chiaroscuro_tpu_torch.render import integrator
from chiaroscuro_tpu_torch.render.renderer import render_image, render_samples
from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA, cornell_box
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.obj_loader import Mesh
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    build_scene_tensors,
    params_from_numpy,
    scene_tensors_from_numpy,
)
from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA


def _port_scene(sa):
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    return scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")


def _grad(loss, params):
    """(loss value, {name: grad as numpy}) of a port loss at numpy params."""
    p = params_from_numpy(params, "cpu")
    value = loss(p)
    value.backward()
    return float(value.detach()), {k: v.grad.numpy() for k, v in p.items()}


# ---------------------------------------------------------------------------
# tests/test_gradients.py, ported (the dense path).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    scene = build_scene_tensors(cornell_box(), device="cpu")
    cam = CORNELL_CAMERA
    cfg = RenderConfig(
        xres=12, yres=12, k=2, samples=8, seed=0, intersector="dense",
        vp=cam["eye"], la=cam["center"], up=cam["up"], yview=cam["yview"],
        platform="cpu",
    )
    return scene, cfg


def _loss_builder(scene, cfg, reduce=torch.mean):
    """loss(params) = reduce of the rendered image with params substituted
    (render_image builds the intersectors from the substituted scene)."""

    def loss(params):
        return reduce(render_image(scene.replace(**params), cfg))

    return loss


def _fd_check(loss, scene, field, idx, eps, rtol, min_grad=1e-7):
    """Central finite difference on one coordinate vs autograd
    (tests/test_gradients.py:50)."""
    base = getattr(scene, field).numpy()
    _, g = _grad(loss, {field: base})
    g_val = float(g[field][idx])

    def perturb(delta):
        arr = base.copy()
        arr[idx] += delta
        with torch.no_grad():
            return float(loss({field: torch.from_numpy(arr)}))

    fd = (perturb(eps) - perturb(-eps)) / (2 * eps)
    if abs(fd) < min_grad and abs(g_val) < min_grad:
        return
    assert np.isclose(g_val, fd, rtol=rtol), (
        f"{field}[{idx}]: autograd {g_val:.6e} vs FD {fd:.6e}"
    )


def test_grad_wrt_kd(setup):
    scene, cfg = setup
    _fd_check(_loss_builder(scene, cfg), scene, "kd", (0, 0), eps=1e-3, rtol=0.05)


def test_grad_wrt_ke(setup):
    """Light emission is linear in Ke: autograd == FD to high accuracy."""
    scene, cfg = setup
    light_idx = int(scene.light_ids[0])
    _fd_check(_loss_builder(scene, cfg), scene, "ke", (light_idx, 1), eps=1e-2, rtol=0.01)


def test_grad_ke_linearity(setup):
    scene, cfg = setup
    loss = _loss_builder(scene, cfg)
    with torch.no_grad():
        base = float(loss({"ke": scene.ke}))
        double = float(loss({"ke": scene.ke * 2.0}))
    assert np.isclose(double, 2 * base, rtol=1e-4)


def test_grad_wrt_vertex_positions(setup):
    """Gradients reach the geometry through the barycentric hit point and
    the NEE geometric term; the hit id is detached, so only finiteness and
    flow are asserted (tests/test_gradients.py:97)."""
    scene, cfg = setup
    _, g = _grad(_loss_builder(scene, cfg), {"tri_v0": scene.tri_v0.numpy()})
    assert np.isfinite(g["tri_v0"]).all()
    assert np.abs(g["tri_v0"]).sum() > 0


def test_grad_wrt_vertex_positions_fd(setup):
    """FD equality at the JAX test's interior-safe coordinates (no sampled
    ray crosses an edge inside the eps interval), on the image sum."""
    scene, cfg = setup
    loss = _loss_builder(scene, cfg, reduce=torch.sum)
    _, g = _grad(loss, {"tri_v0": scene.tri_v0.numpy()})
    eps = 1e-2
    for tri, ax in ((11, 2), (6, 0)):
        arr = scene.tri_v0.numpy().copy()
        with torch.no_grad():
            arr[tri, ax] += eps
            lp = float(loss({"tri_v0": torch.from_numpy(arr.copy())}))
            arr[tri, ax] -= 2 * eps
            lm = float(loss({"tri_v0": torch.from_numpy(arr)}))
        fd = (lp - lm) / (2 * eps)
        assert np.isclose(g["tri_v0"][tri, ax], fd, rtol=0.1), (
            f"tri_v0[{tri},{ax}]: autograd {g['tri_v0'][tri, ax]:.5e} vs FD {fd:.5e}"
        )


def _textured_quad():
    quad_pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    mesh = Mesh(
        name="q:tex", positions=quad_pos, normals=np.array([[0, 0, 1]] * 4, np.float32),
        uvs=np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        diffuse=np.array([0.5, 0.5, 0.5], np.float32), emissive=np.zeros(3, np.float32),
        ambient=np.zeros(3, np.float32), specular=np.zeros(3, np.float32),
        shininess=0.0, texture_diffuse="mem://checker",
    )
    light = Mesh(
        name="l:light",
        positions=np.array([[-0.3, 0.3, 2.0], [0.3, 0.3, 2.0], [0, -0.3, 2.0]], np.float32),
        normals=np.array([[0, 0, -1]] * 3, np.float32), uvs=np.zeros((3, 2), np.float32),
        indices=np.array([[0, 1, 2]], np.int32), diffuse=np.ones(3, np.float32),
        emissive=np.array([5.0, 5.0, 5.0], np.float32), ambient=np.zeros(3, np.float32),
        specular=np.zeros(3, np.float32), shininess=0.0,
    )
    tex = np.linspace(0.1, 0.9, 4 * 4 * 3).reshape(4, 4, 3).astype(np.float32)
    scene = build_scene_tensors([mesh, light], textures={"mem://checker": tex}, device="cpu")
    cfg = RenderConfig(
        xres=8, yres=8, k=1, samples=4, seed=0, intersector="dense",
        vp=(0, 0, 3), la=(0, 0, 0), up=(0, 1, 0), yview=0.8, platform="cpu",
    )
    return scene, cfg


def test_grad_wrt_texture_texels():
    """d loss / d texel is nonzero exactly for texels hit by rays; FD on
    the most-hit texel (tests/test_gradients.py:145)."""
    scene, cfg = _textured_quad()
    loss = _loss_builder(scene, cfg)
    _, g = _grad(loss, {"tex_data": scene.tex_data.numpy()})
    g = g["tex_data"]
    assert np.isfinite(g).all()
    assert (np.abs(g).sum(axis=-1) > 0).any()
    idx = int(np.abs(g).sum(axis=-1).argmax())
    _fd_check(loss, scene, "tex_data", (idx, 0), eps=1e-2, rtol=0.05)


def test_grads_finite_through_deep_paths(setup):
    scene, cfg = setup
    cfg = dataclasses.replace(cfg, k=3, samples=4)
    _, grads = _grad(_loss_builder(scene, cfg),
                     {"kd": scene.kd.numpy(), "ke": scene.ke.numpy()})
    for k, v in grads.items():
        assert np.isfinite(v).all(), k


def _pixels(xres, yres):
    ys, xs = torch.meshgrid(torch.arange(yres), torch.arange(xres), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def test_checkpoint_gradients_match_no_checkpoint(setup):
    """``render_samples(checkpoint=True)`` (the counterpart of remat) gives
    the same loss and gradients: the recompute runs the same ops on the
    same inputs, so they are bitwise equal (the JAX test's bound is rtol
    1e-6 / 1e-5)."""
    scene, cfg = setup
    cam = CORNELL_CAMERA
    px, py = _pixels(cfg.xres, cfg.yres)

    def make_loss(checkpoint):
        def loss(params):
            s = scene.replace(**params)
            cf, af = make_intersectors(s, "dense")
            img = render_samples(
                s, cam["eye"], cam["center"], cam["up"], cam["yview"], cfg.xres,
                cfg.yres, px, py, 0, cfg.samples, 0, cfg.k, (0.0, 0.0, 0.0),
                cf, af, checkpoint=checkpoint,
            )
            return img.mean()
        return loss

    params = {"kd": scene.kd.numpy(), "ke": scene.ke.numpy(), "tri_v0": scene.tri_v0.numpy()}
    l0, g0 = _grad(make_loss(False), params)
    l1, g1 = _grad(make_loss(True), params)
    assert l0 == l1
    for k in params:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)


# ---------------------------------------------------------------------------
# Against jax.grad of the same loss.
# ---------------------------------------------------------------------------

RES = (16, 16)


def _cornell_case():
    sa = build_scene_arrays(jax_cornell_box())
    cam = CORNELL_CAMERA
    return dict(sa=sa, cam=cam, spp=2, depth=3, seed=0, fields=("kd", "ke", "tri_v0"),
                jax_pair=lambda s: make_pallas_intersectors(s, interpret=True),
                port_pair=lambda s: make_intersectors(s, "dense"))


def _atrium_case():
    sa = build_scene_arrays(jax_atrium(2_200, seed=5))
    jca = jax_build_clusters(np.asarray(sa.tri_v0), np.asarray(sa.tri_v1),
                             np.asarray(sa.tri_v2), 32)
    ca = cluster_arrays_from_numpy(dataclasses.asdict(jca))
    # 99% of the atrium's triangles are textured, so its albedo gradient
    # lands in the texels, and kd's is zero in both packages.
    return dict(sa=sa, cam=ATRIUM_CAMERA, spp=1, depth=2, seed=3,
                fields=("kd", "ke", "tri_v0", "tex_data"),
                jax_pair=lambda s: jax_make_cluster_intersectors(
                    s, M=32, interpret=True, stream=False, clusters=jca),
                port_pair=lambda s: make_intersectors(s, "cluster", clusters=ca))


def _weights(n):
    """Pixel weights of tests/test_cluster.py's loss, so that gradients do
    not cancel by symmetry."""
    return np.linspace(0.5, 1.5, n, dtype=np.float32)


def _jax_value_and_grad(case):
    sa, cam = case["sa"], case["cam"]
    px, py = (np.asarray(x, np.int32) for x in _pixels(*RES))
    w = jnp.asarray(_weights(RES[0] * RES[1] * 3).reshape(-1, 3))

    def loss(params):
        s = dataclasses.replace(sa, **params)
        cf, af = case["jax_pair"](s)
        img = jax_render_samples(
            s, jnp.asarray(cam["eye"], jnp.float32), jnp.asarray(cam["center"], jnp.float32),
            jnp.asarray(cam["up"], jnp.float32), jnp.float32(cam["yview"]), RES[0], RES[1],
            jnp.asarray(px), jnp.asarray(py), jnp.int32(0), case["spp"],
            jnp.uint32(case["seed"]), case["depth"], jnp.zeros(3, jnp.float32), cf, af,
        )
        return jnp.mean(img * w)

    params = {k: getattr(sa, k) for k in case["fields"]}
    value, grads = jax.value_and_grad(loss)(params)
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


def _port_loss(case, scene, launches=None):
    cam = case["cam"]
    px, py = _pixels(*RES)
    w = torch.from_numpy(_weights(RES[0] * RES[1] * 3).reshape(-1, 3))

    def loss(params):
        s = scene.replace(**params)
        cf, af = case["port_pair"](s)
        if launches is not None:
            launches.append(getattr(cf, "route", "dense"))
        img = render_samples(
            s, cam["eye"], cam["center"], cam["up"], cam["yview"], RES[0], RES[1],
            px, py, 0, case["spp"], case["seed"], case["depth"], (0.0, 0.0, 0.0), cf, af,
        )
        return (img * w).mean()

    return loss


@pytest.mark.parametrize("name", ["cornell_dense", "atrium_cluster"])
def test_grads_match_jax(name):
    """Found, as max |port - JAX| over the largest JAX entry: Cornell (the
    K1 path, vs the interpreted Pallas K1 and its VJP) kd 2.2e-7, ke
    1.3e-7, tri_v0 7.8e-7; atrium(2_200) at M = 32 (the plain K4 route, vs
    JAX's interpreted resident kernels and its cluster VJP) ke 2.5e-6,
    tri_v0 1.8e-6, tex_data 4.6e-6, kd zero in both."""
    case = _cornell_case() if name == "cornell_dense" else _atrium_case()
    sa = case["sa"]
    routes = []
    value, grads = _grad(_port_loss(case, _port_scene(sa), routes),
                         {k: np.asarray(getattr(sa, k)) for k in case["fields"]})
    assert routes == (["dense"] if name == "cornell_dense" else ["resident"])
    ref_value, ref = _jax_value_and_grad(case)
    np.testing.assert_allclose(value, ref_value, rtol=1e-5)
    for k in case["fields"]:
        scale = float(np.abs(ref[k]).max())
        assert np.isfinite(grads[k]).all(), k
        np.testing.assert_allclose(grads[k], ref[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    assert all(np.abs(ref[k]).max() > 0 for k in case["fields"] if k != "kd" or
               name == "cornell_dense")


def test_closest_vjp_matches_jax():
    """The closest-hit backward alone: the same rays and cotangents through
    the port's ``closest_dense`` (the autograd Function over the plain K1)
    and JAX's ``_closest_diff`` VJP (interpreted K1).  Bound: rtol 1e-4,
    atol 2e-6 x the largest entry (op-by-op rounding vs XLA's FMAs in the
    recompute); found: o3 and attrs exact, d3 6.4e-8, tri_rows 4.3e-8."""
    from chiaroscuro_tpu.ops.intersect_pallas import (
        _closest_diff,
        _prep_attrs,
        _prep_tris,
        _tri_chunk_for,
    )

    sa = build_scene_arrays(jax_cornell_box())
    scene = _port_scene(sa)
    rng = np.random.default_rng(17)
    B0 = 3
    lo, hi = scene.world_min.numpy(), scene.world_max.numpy()
    o3 = rng.uniform(lo[:, None, None], hi[:, None, None], (3, B0, 128)).astype(np.float32)
    d3 = rng.normal(size=(3, B0, 128)).astype(np.float32)
    cts = [rng.normal(size=(B0, 128)).astype(np.float32) for _ in range(3)]
    ct_am = rng.normal(size=(ic.ATTR_K, B0, 128)).astype(np.float32)

    T = scene.n_tris
    chunk = _tri_chunk_for(T)
    jrows = _prep_tris(sa.tri_v0, sa.tri_v1, sa.tri_v2, chunk)
    jattrT = _prep_attrs(sa, chunk)
    live = jnp.ones((8, 1), jnp.float32)

    def jloss(o3, d3, rows, attrT):
        pad = ((0, 0), (0, 8 - B0), (0, 0))
        t, _, u, v, am = _closest_diff(live, jnp.pad(o3, pad), jnp.pad(d3, pad), rows, attrT,
                                       chunk, True)
        hit = (t < ic.BIG)[:B0]
        return (jnp.sum(jnp.where(hit, t[:B0], 0.0) * cts[0]) + jnp.sum(u[:B0] * cts[1])
                + jnp.sum(v[:B0] * cts[2]) + jnp.sum(am[:, :B0] * ct_am))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(jnp.asarray(o3), jnp.asarray(d3), jrows, jattrT)

    p = {k: torch.from_numpy(x).requires_grad_() for k, x in dict(o3=o3, d3=d3).items()}
    rows = ic._prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2).requires_grad_()
    attrs = ic._prep_attrs(scene).requires_grad_()
    t, _, u, v, am = ic.closest_dense(None, p["o3"], p["d3"], rows, attrs)
    hit = t < ic.BIG
    assert 0.2 < float(hit.float().mean()) < 0.98
    loss = ((torch.where(hit, t, 0.0) * torch.from_numpy(cts[0])).sum()
            + (u * torch.from_numpy(cts[1])).sum() + (v * torch.from_numpy(cts[2])).sum()
            + (am * torch.from_numpy(ct_am)).sum())
    loss.backward()
    got = [p["o3"].grad.numpy(), p["d3"].grad.numpy(), rows.grad.numpy(), attrs.grad.numpy()]
    want = [np.asarray(jg[0]), np.asarray(jg[1]), np.asarray(jg[2])[:T],
            np.asarray(jg[3])[:, :T].T]
    for name, a, b in zip(("o3", "d3", "tri_rows", "attrs"), got, want):
        scale = float(np.abs(b).max())
        assert scale > 0, name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-6 * scale, err_msg=name)


# ---------------------------------------------------------------------------
# The cluster gradients against the brute path, and the parameter bridge.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stream", [False, True])
def test_cluster_gradients_match_bruteforce(stream):
    """tests/test_cluster.py:196-242 on the port: kd, ke and tri_v0
    gradients through the cluster pair (the plain K4, or K6 with
    ``stream=True``, inside the closest-hit Function) against the brute
    oracle's, under that test's bound."""
    scene = build_scene_tensors(cornell_box(), device="cpu")
    ca = cc.build_clusters(*(x.numpy() for x in (scene.tri_v0, scene.tri_v1, scene.tri_v2)), 8)
    px, py = _pixels(16, 16)
    w = torch.linspace(0.5, 1.5, 16 * 16 * 3).reshape(-1, 3)

    def make_loss(method):
        def loss(params):
            s = scene.replace(**params)
            if method == "cluster":
                cf, af = cc.make_cluster_intersectors(s, M=8, Lmax=8, clusters=ca,
                                                      stream=stream)
                assert cf.route == ("stream" if stream else "resident")
            else:
                cf, af = make_intersectors(s, "brute")
            img = render_samples(s, (0.0, 1.0, 3.2), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0), 1.0,
                                 16, 16, px, py, 0, 2, 3, 3, (0.0, 0.0, 0.0), cf, af)
            return (img * w).mean()
        return loss

    params = {k: getattr(scene, k).numpy() for k in ("kd", "ke", "tri_v0")}
    _, g_cluster = _grad(make_loss("cluster"), params)
    _, g_brute = _grad(make_loss("brute"), params)
    for k in params:
        assert np.isfinite(g_cluster[k]).all(), k
        assert np.abs(g_brute[k]).max() > 0, k
        np.testing.assert_allclose(g_cluster[k], g_brute[k], rtol=2e-3, atol=1e-6, err_msg=k)


def test_every_substituted_field_reaches_the_integrator(monkeypatch):
    """``SceneTensors.replace`` hands the integrator the substituted tensors
    themselves, for every data field, and the float fields that shade a
    textured, lit render get gradients from its loss; params_from_numpy
    makes leaves that require grad where the field is float."""
    scene, cfg = _textured_quad()
    params = params_from_numpy({k: getattr(scene, k).numpy() for k in DATA_FIELDS}, "cpu")
    for k, v in params.items():
        assert v.is_leaf and v.requires_grad == v.is_floating_point(), k
    seen = {}
    trace = integrator.trace_paths_planar

    def spy(s, *args, **kwargs):
        seen.update({k: getattr(s, k) for k in DATA_FIELDS})
        return trace(s, *args, **kwargs)

    monkeypatch.setattr("chiaroscuro_tpu_torch.render.renderer.trace_paths_planar", spy)
    render_image(scene.replace(**params), cfg).mean().backward()
    for k in DATA_FIELDS:
        assert seen[k] is params[k], k
    # (The quad is textured, so its albedo gradient lands in the texels, not
    # kd; a nearest-texel fetch gives texcoords none.)
    for k in ("tri_v0", "tri_v1", "tri_v2", "normal", "ke", "tex_data", "light_areas"):
        g = params[k].grad
        assert g is not None and torch.isfinite(g).all() and bool(g.abs().sum() > 0), k
    with pytest.raises(ValueError, match="not a data field"):
        scene.replace(n_tris=3)
    with pytest.raises(ValueError, match="shape"):
        scene.replace(kd=scene.kd[:1])
