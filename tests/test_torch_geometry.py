"""Camera rays, planar vec3 math and the brute-force oracle of the port
against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.geometry import camera as jcamera
from chiaroscuro_tpu.geometry import intersect as jintersect
from chiaroscuro_tpu.geometry import planar as JP
from chiaroscuro_tpu.scene.builtin import CORNELL_CAMERA
from chiaroscuro_tpu_torch.geometry import camera, intersect
from chiaroscuro_tpu_torch.geometry import planar as P
from chiaroscuro_tpu_torch.scene.builtin import cornell_box
from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors

CAMERAS = [
    (CORNELL_CAMERA["eye"], CORNELL_CAMERA["center"], CORNELL_CAMERA["up"],
     CORNELL_CAMERA["yview"], 768, 768),
    ((0.0, 0.0, 2.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 1.0, 64, 64),
    ((0.3, 1.1, 2.95), (-0.2, 0.9, 0.1), (0.1, 1.0, 0.0), 0.8, 160, 90),
]


@pytest.mark.parametrize("cam", CAMERAS)
def test_camera_rays_match_jax(cam):
    """The basis is the JAX package's numpy branch: exact.  Directions are
    one multiply-add chain per component: within 1 ulp (XLA may contract it
    into FMAs)."""
    basis = camera.camera_basis(*cam)
    ref = jcamera.camera_basis(*cam)
    for b, r in zip(basis, ref):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(r))

    xres, yres = cam[4], cam[5]
    rng = np.random.default_rng(xres)
    px = rng.integers(0, xres, (4, 128)).astype(np.float32)
    py = rng.integers(0, yres, (4, 128)).astype(np.float32)
    jx = rng.uniform(size=(4, 128)).astype(np.float32)
    jy = rng.uniform(size=(4, 128)).astype(np.float32)
    dirs = camera.primary_ray_dirs_planar(
        *(torch.from_numpy(np.asarray(b)) for b in basis),
        *(torch.from_numpy(x) for x in (px, py, jx, jy)),
    )
    rdirs = jcamera.primary_ray_dirs_planar(
        *(jnp.asarray(b) for b in ref), *(jnp.asarray(x) for x in (px, py, jx, jy)),
    )
    assert dirs.shape == (3, 4, 128)
    np.testing.assert_array_max_ulp(dirs.numpy(), np.asarray(rdirs), maxulp=1)


def test_planar_helpers_match_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 2, 128)).astype(np.float32)
    b = rng.normal(size=(3, 2, 128)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for got, ref in [
        (P.pdot(ta, tb), JP.pdot(ja, jb)),
        (P.pcross(ta, tb), JP.pcross(ja, jb)),
        (P.pnorm(ta), JP.pnorm(ja)),
        (P.pnormalize(ta), JP.pnormalize(ja)),
    ]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    rows = P.to_rows(ta)
    assert rows.shape == (256, 3)
    assert torch.equal(P.to_planar(rows, (2, 128)), ta)


def _rays(scene, rng, n):
    lo, hi = scene.world_min.numpy(), scene.world_max.numpy()
    o = rng.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo), (n, 3))
    d = rng.normal(size=(n, 3))
    return o.astype(np.float32), d.astype(np.float32)


def test_brute_oracle_matches_jax():
    """hit equal; tid equal or a tie within rtol 1e-6 (tests/test_pallas.py
    :48-50); t within rtol 1e-6; occlusion equal."""
    scene = build_scene_tensors(cornell_box())
    rng = np.random.default_rng(11)
    o, d = _rays(scene, rng, 1000)
    tris = [getattr(scene, k) for k in ("tri_v0", "tri_v1", "tri_v2")]
    jtris = [jnp.asarray(x.numpy()) for x in tris]
    hit, t, tid, u, v = intersect.intersect_closest_bruteforce(
        torch.from_numpy(o), torch.from_numpy(d), *tris, chunk=16
    )
    rh, rt, rtid, ru, rv = (
        np.asarray(x) for x in jintersect.intersect_closest_bruteforce(
            jnp.asarray(o), jnp.asarray(d), *jtris)
    )
    hit, t, tid = hit.numpy(), t.numpy(), tid.numpy()
    np.testing.assert_array_equal(hit, rh)
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-6)
    same = tid[hit] == rtid[hit]
    ties = np.isclose(t[hit], rt[hit], rtol=1e-6)
    assert (same | ties).all()

    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(10, 1200, 1000).astype(np.float32)
    excl = rng.integers(0, scene.n_tris, 1000).astype(np.int32)
    occ = intersect.intersect_any_bruteforce(
        torch.from_numpy(o), torch.from_numpy(d), *tris,
        torch.from_numpy(tmax), torch.from_numpy(excl), chunk=16,
    )
    ref = jintersect.intersect_any_bruteforce(
        jnp.asarray(o), jnp.asarray(d), *jtris, jnp.asarray(tmax), jnp.asarray(excl)
    )
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref))
