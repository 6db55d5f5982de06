"""The port's BVH (``accel/bvh.py``) on the CPU against the JAX package's
(``chiaroscuro_tpu/accel/bvh.py``) and against the port's brute oracle.

Both packages build from the same vertices (a JAX ``SceneArrays`` read out
as numpy and carried into the port).  On CPU tensors the intersector pair
runs the plain walk, the JAX package's lock-step loop op for op; the card's
kernels B1/B2 are held against it in tests/test_torch_cuda.py.

Tolerances, each with its reason:

- Builds: array for array equal (the same numpy or C++ code on the same
  float32 input).
- Walk against JAX's ``bvh_closest`` / ``bvh_any``: hit and occlusion flags
  and ids equal, except where the port's answer is the least (t, id) hit
  (or the occlusion) that :func:`_brute` reports; t within rtol 2e-6 and
  u, v within 1e-5 absolute where ids agree.  The port pads its boxes and
  takes the least (t, id) (``accel/bvh.py``); the JAX package walks tight
  boxes and keeps walk order, so it loses hits on a box's face, blockers
  just short of tmax and ties to a smaller id, and its on-plane axis rays
  meet NaN at the triangles' planes (ROADMAP section 3).  Not bitwise
  elsewhere: XLA contracts the Moller-Trumbore products into FMAs on the
  CPU, torch rounds each op (found: t within 2.4e-7 relative; u and v
  within 1.7e-7 on Cornell and 3.4e-6 on atrium(2_200)).
- Walk against :func:`_brute` (every triangle, the walk's Moller-Trumbore,
  the least (t, id)) and the benchmark's reference
  (``benchmarks/reference/accel.py``): exact, on the cases built to meet
  each rule (ties, a box's face, a blocker at tmax).
- Walk against the brute oracle of ``geometry/intersect.py``:
  tests/test_bvh.py's own bounds.
- Renders: the render bound of ROADMAP section 3 (mean |d| <= 1e-4 x mean
  radiance, at most 0.5% of pixels outside rtol 1e-3).
- Gradients w.r.t. (kd, ke) against ``jax.grad`` through JAX's BVH:
  relative L1 <= 1e-5, the Cornell bound of tests/test_torch_gradients.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.accel import bvh as jbvh
from chiaroscuro_tpu.accel.dispatch import make_intersectors as jax_make_intersectors
from chiaroscuro_tpu.render.renderer import Renderer as JaxRenderer
from chiaroscuro_tpu.render.renderer import render_image as jax_render_image
from chiaroscuro_tpu.render.renderer import render_samples as jax_render_samples
from chiaroscuro_tpu.scene.builtin import cornell_box as jax_cornell_box
from chiaroscuro_tpu.scene.config import RenderConfig as JaxRenderConfig
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu.scene.scene_arrays import load_scene as jax_load_scene
from chiaroscuro_tpu.scene.synthetic import atrium as jax_atrium
from benchmarks.drivers import frame
from benchmarks.harness import program
from benchmarks.reference import accel as ref_accel
from benchmarks.reference import scene as ref_scene
from benchmarks.scenes.mesh import Mesh
from chiaroscuro_tpu_torch import cli
from chiaroscuro_tpu_torch.accel import bvh
from chiaroscuro_tpu_torch.accel.clusters import BOX_PAD
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.geometry.intersect import (
    intersect_any_bruteforce,
    intersect_closest_bruteforce,
)
from chiaroscuro_tpu_torch.ops import bvh_cuda
from chiaroscuro_tpu_torch.ops.intersect_cuda import _mt_core
from chiaroscuro_tpu_torch.render.renderer import render_image, render_samples
from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    params_from_numpy,
    scene_tensors_from_numpy,
)
from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA

BUILD_FIELDS = ("bbox_min", "bbox_max", "miss_link", "leaf_start", "leaf_count",
                "tri_order", "tri_v0", "tri_e1", "tri_e2")


def _port_scene(sa):
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    return scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")


def _cam_tokens(cam):
    return ["VP", *map(str, cam["eye"]), "LA", *map(str, cam["center"]),
            "UP", *map(str, cam["up"]), "yview", str(cam["yview"])]


def assert_render_close(img, ref, mean_rel=1e-4, outlier_share=0.005):
    """The render bound stated in the module docstring."""
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    mean_abs = float(np.abs(img - ref).mean())
    assert mean_abs <= mean_rel * float(ref.mean()), (mean_abs, float(ref.mean()))
    outside = ~np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    assert outside.mean() <= outlier_share, outside.mean()


SCENES = {
    "cornell": (lambda: build_scene_arrays(jax_cornell_box()), 4),
    "atrium2200": (lambda: build_scene_arrays(jax_atrium(2_200)), 8),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def built(request):
    make, leaf = SCENES[request.param]
    sa = make()
    scene = _port_scene(sa)
    return request.param, sa, scene, jbvh.build_bvh(sa, leaf_size=leaf), \
        bvh.build_bvh(scene, leaf_size=leaf)


# ---------------------------------------------------------------------------
# Builds.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("native", [True, False])
def test_build_matches_jax(name, native):
    """The port's build equals the JAX package's, array for array, through
    the C++ builder and through the numpy one: the build's own boxes
    before the pad, then the stored boxes are those less and plus
    ``BOX_PAD`` in float32."""
    make, leaf = SCENES[name]
    sa = make()
    ref = jbvh.build_bvh(sa, leaf_size=leaf, native=native)
    scene = _port_scene(sa)
    got = bvh.build_bvh(scene, leaf_size=leaf, native=native)
    assert got.builder == ("native" if native else "numpy")
    assert (got.n_nodes, got.leaf_size) == (ref.n_nodes, ref.leaf_size)
    v = [getattr(scene, f).numpy() for f in ("tri_v0", "tri_v1", "tri_v2")]
    built = bvh._build_host_native(*v, leaf) if native else bvh._build_host(*v, leaf)
    pad = np.float32(BOX_PAD)
    for f, b, sign in (("bbox_min", built[0], -1), ("bbox_max", built[1], 1)):
        np.testing.assert_array_equal(b, np.asarray(getattr(ref, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f).numpy(), b + sign * pad, err_msg=f)
    for f in BUILD_FIELDS[2:]:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_native_builder_matches_numpy():
    """The port's C++ builder (csrc/bvh_builder.cpp, built with g++ into
    _build/) reproduces its numpy builder's layout on random geometry."""
    rng = np.random.default_rng(7)
    T = 500
    v0 = rng.uniform(-2, 2, (T, 3)).astype(np.float32)
    v1 = (v0 + rng.uniform(-0.3, 0.3, (T, 3))).astype(np.float32)
    v2 = (v0 + rng.uniform(-0.3, 0.3, (T, 3))).astype(np.float32)
    nat = bvh._build_host_native(v0, v1, v2, 8)
    assert nat is not None, "native BVH library failed to build"
    ref = bvh._build_host(v0, v1, v2, 8)
    for name, a, b in zip(BUILD_FIELDS, nat, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_build_invariants(built):
    """tests/test_bvh.py::test_build_invariants on the port's build."""
    _, _, scene, _, b = built
    ls, lc = b.leaf_start.numpy(), b.leaf_count.numpy()
    order, miss = b.tri_order.numpy(), b.miss_link.numpy()
    covered = []
    for s, c in zip(ls, lc):
        if c > 0:
            covered.extend(order[s:s + c].tolist())
    assert sorted(covered) == list(range(scene.n_tris))
    assert lc.max() <= b.leaf_size
    assert miss[0] == -1
    n = b.n_nodes
    assert all(miss[i] == -1 or i < miss[i] < n + 1 for i in range(n))
    bmn, bmx = b.bbox_min.numpy(), b.bbox_max.numpy()
    assert (bmn >= bmn[0] - 1e-5).all() and (bmx <= bmx[0] + 1e-5).all()


# ---------------------------------------------------------------------------
# The walk.
# ---------------------------------------------------------------------------


def _rays(sa, seed, n=512, on_plane=True):
    """n seeded random rays around the scene, then (``on_plane``) the
    axis-aligned rays that start on the scene box's planes and on up to four
    axis planes of triangles per axis (Cornell's walls): 0 * inf = NaN in
    those slab tests.  Their origins sit off the walls' diagonals: at an
    exact edge (u = 0 in exact arithmetic) XLA's FMA rounds u to -1.4e-8 and
    rejects a hit that op-by-op rounding accepts, a flip of the rounding
    tolerance, not of the NaN rule under test."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(sa.world_min), np.asarray(sa.world_max)
    o = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (n, 3))
    d = rng.normal(size=(n, 3))
    if not on_plane:
        return o.astype(np.float32), d.astype(np.float32)
    mid = lo + np.array([0.3, 0.45, 0.6]) * (hi - lo)
    planes = {(a, float(x)) for a in range(3) for x in (lo[a], hi[a])}
    v0, v1, v2 = (np.asarray(getattr(sa, f)) for f in ("tri_v0", "tri_v1", "tri_v2"))
    for a in range(3):
        flat = (v0[:, a] == v1[:, a]) & (v1[:, a] == v2[:, a])
        planes |= {(a, float(x)) for x in np.unique(v0[flat, a])[:4]}
    extra_o, extra_d = [], []
    for a, x in sorted(planes):
        for b in range(3):
            for sign in (1.0, -1.0):
                p = mid.copy()
                p[a] = x
                dd = np.zeros(3)
                dd[b] = sign
                extra_o.append(p)
                extra_d.append(dd)
    o = np.concatenate([o, extra_o]).astype(np.float32)
    d = np.concatenate([d, extra_d]).astype(np.float32)
    return o, d


def _brute(scene, o, d, tmax=None, excl=None):
    """Every triangle against every ray with the walk's Moller-Trumbore
    (``_mt_core``, the kernels' arithmetic): (hit, t, tid) of the least
    (t, id) hit, t = inf and tid 0 on a miss; with ``tmax`` and ``excl``
    the occlusion by a triangle other than ``excl`` at t < tmax."""
    def comps(x):
        return tuple(x[..., a] for a in range(3))

    v0 = scene.tri_v0
    ok, t, _, _ = _mt_core(comps(o[None]), comps(d[None]), comps(v0[:, None]),
                           comps((scene.tri_v1 - v0)[:, None]),
                           comps((scene.tri_v2 - v0)[:, None]))       # (T, R)
    ids = torch.arange(v0.shape[0], dtype=torch.int32)[:, None]
    if tmax is not None:
        return (ok & (t < tmax[None]) & (ids != excl[None])).any(dim=0)
    t = torch.where(ok, t, float("inf"))
    tmin = t.amin(dim=0)
    tid = torch.where(t == tmin[None], ids, v0.shape[0]).amin(dim=0)
    hit = torch.isfinite(tmin)
    return hit, tmin, torch.where(hit, tid, 0)


def test_closest_matches_jax(built):
    """Plain ``bvh_closest`` against JAX's, on 512 seeded rays plus the
    axis-aligned on-plane ones, under the module's tolerance: where the two
    differ in the hit or the id, the port's hit is :func:`_brute`'s least
    (t, id), bit for bit (found: the on-plane rays, which meet NaN at the
    triangles' planes in JAX's tight boxes, and the ties)."""
    _, sa, scene, jb, pb = built
    o, d = _rays(sa, 11)
    ref = [np.asarray(x) for x in jbvh.bvh_closest(jb, jnp.asarray(o), jnp.asarray(d))]
    got = [x.numpy() for x in bvh.bvh_closest(pb, torch.from_numpy(o), torch.from_numpy(d))]
    oh, ot, otid = (x.numpy() for x in _brute(scene, torch.from_numpy(o), torch.from_numpy(d)))
    differ = (got[0] != ref[0]) | (got[0] & (got[2] != ref[2]))
    np.testing.assert_array_equal(got[0][differ], oh[differ])
    np.testing.assert_array_equal(got[1][differ].view(np.int32), ot[differ].view(np.int32))
    np.testing.assert_array_equal(got[2][differ], otid[differ])
    hit = ref[0] & ~differ
    assert 0.2 < hit.mean() < 0.95
    assert np.isinf(got[1][~got[0]]).all()
    np.testing.assert_allclose(got[1][hit], ref[1][hit], rtol=2e-6, atol=0.0)
    for k in (3, 4):
        np.testing.assert_allclose(got[k][hit], ref[k][hit], rtol=0, atol=1e-5)


def test_any_matches_jax(built):
    """Plain ``bvh_any`` against JAX's on the same rays, tmax seeded across
    the scene's span, exclude ids seeded among the triangles: equal, except
    where the port's occlusion is :func:`_brute`'s (the on-plane rays)."""
    _, sa, scene, jb, pb = built
    o, d = _rays(sa, 12)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rng = np.random.default_rng(13)
    span = float(np.linalg.norm(np.asarray(sa.world_max) - np.asarray(sa.world_min)))
    tmax = rng.uniform(0.05, 1.0, len(o)).astype(np.float32) * span
    excl = rng.integers(0, scene.n_tris, len(o)).astype(np.int32)
    ref = np.asarray(jbvh.bvh_any(jb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                                  jnp.asarray(excl)))
    args = [torch.from_numpy(x) for x in (o, d, tmax, excl)]
    got = bvh.bvh_any(pb, *args).numpy()
    differ = got != ref
    np.testing.assert_array_equal(got[differ], _brute(scene, *args).numpy()[differ])
    assert differ.mean() < 0.05
    assert 0.05 < ref.mean() < 0.95


def test_on_plane_axis_rays_miss_the_scene_box(built):
    """An axis-parallel ray whose origin lies on a slab plane of the root
    box meets 0 * inf = NaN there; NaN propagates through the slab test's
    min/max and the box misses (the JAX package's rule, which the kernels
    keep), so the walk ends at its first step."""
    _, _, _, jb, pb = built
    lo, hi = pb.bbox_min[0].numpy(), pb.bbox_max[0].numpy()       # the root box
    o = np.tile(lo + np.array([0.3, 0.45, 0.6], np.float32) * (hi - lo), (3, 1))
    o[:, 1] = lo[1]                                 # on the root box's floor plane
    d = np.eye(3, dtype=np.float32)                 # x and z parallel to it
    hit, *_, (steps, tests) = bvh.bvh_closest(pb, torch.from_numpy(o), torch.from_numpy(d),
                                               counts=True)
    ref = np.asarray(jbvh.bvh_closest(jb, jnp.asarray(o), jnp.asarray(d))[0])
    np.testing.assert_array_equal(hit.numpy(), ref)
    assert not hit[0] and not hit[2]
    assert steps[0] == 1 and steps[2] == 1 and tests[0] == 0


def test_walk_matches_brute_oracle(built):
    """tests/test_bvh.py's oracle checks on the port, on its random rays
    (the on-plane axis rays miss the BVH's boxes by the NaN rule, where the
    oracle tests every triangle): closest hits (ids equal or t-ties),
    occlusion exact, every triangle reachable."""
    _, sa, scene, _, pb = built
    o, d = (torch.from_numpy(x) for x in _rays(sa, 14, n=256, on_plane=False))
    tv = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    bh, bt, btid, bu, _ = bvh.bvh_closest(pb, o, d)
    oh, ot, otid, ou, _ = intersect_closest_bruteforce(o, d, *tv)
    assert torch.equal(bh, oh)
    np.testing.assert_allclose(bt[oh].numpy(), ot[oh].numpy(), rtol=1e-5, atol=1e-6)
    agree = (btid == otid)[oh].numpy()
    tie = np.isclose(bt[oh].numpy(), ot[oh].numpy(), rtol=1e-6)
    assert (agree | tie).all()
    np.testing.assert_allclose(bu[oh].numpy()[agree], ou[oh].numpy()[agree], rtol=1e-4,
                               atol=1e-5)

    dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rng = np.random.default_rng(15)
    tmax = torch.from_numpy(rng.uniform(0.1, 100, len(o)).astype(np.float32))
    excl = torch.from_numpy(rng.integers(0, scene.n_tris, len(o)).astype(np.int32))
    assert torch.equal(bvh.bvh_any(pb, o, dn, tmax, excl),
                       intersect_any_bruteforce(o, dn, *tv, tmax, excl))

    cent = ((scene.tri_v0 + scene.tri_v1 + scene.tri_v2) / 3.0)
    eye = scene.world_min + 0.37 * (scene.world_max - scene.world_min)
    oc = eye.expand_as(cent).contiguous()
    bh, bt, *_ = bvh.bvh_closest(pb, oc, cent - oc)
    oh, ot, *_ = intersect_closest_bruteforce(oc, cent - oc, *tv)
    assert torch.equal(bh, oh)
    np.testing.assert_allclose(bt.numpy(), ot.numpy(), rtol=1e-5)


# ---------------------------------------------------------------------------
# The reference's semantics: padded boxes and the least (t, id).
# ---------------------------------------------------------------------------


def _mesh(name, tris, ke=0.0):
    """A benchmark ``Mesh`` of (F, 3, 3) triangle corners, flat normals."""
    tris = np.asarray(tris, np.float32).reshape(-1, 3, 3)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    F = len(tris)
    return Mesh(name, tris.reshape(-1, 3), np.repeat(n, 3, axis=0), np.zeros((3 * F, 2), np.float32),
                np.arange(3 * F, dtype=np.int32).reshape(F, 3), np.full(3, 0.5, np.float32),
                np.full(3, ke, np.float32), np.zeros(3, np.float32), np.zeros(3, np.float32), 1.0)


def _scenes(meshes):
    """The port's scene and the benchmark reference's exact queries
    (``benchmarks/reference/accel.py``) of the same meshes, ids alike."""
    scene, _ = program.port_scene(meshes, {}, "cpu")
    rs = ref_scene.flatten(meshes, {}, "cpu")
    assert torch.equal(scene.tri_v0, rs.v0) and torch.equal(scene.tri_v2, rs.v2)
    return scene, ref_accel.Groups(rs)


def _tight(pb, scene):
    """``pb`` with the build's own boxes, unpadded: the walk as it stood
    before the pad."""
    v = [getattr(scene, f).numpy() for f in ("tri_v0", "tri_v1", "tri_v2")]
    bmin, bmax, *_ = bvh._build_host(*v, pb.leaf_size)
    nodes = pb.nodes.clone()
    nodes[:, 0:3], nodes[:, 4:7] = torch.from_numpy(bmin), torch.from_numpy(bmax)
    return dataclasses.replace(pb, nodes=nodes)


def _closest_is_least(pb, scene, groups, o, d):
    """The plain walk's closest hits equal :func:`_brute`'s and the
    reference's least (t, id) hits, bit for bit; returns its (hit, t, tid)."""
    hit, t, tid, _, _ = bvh.bvh_closest(pb, o, d)
    bh, bt, btid = _brute(scene, o, d)
    rh, rt, rtid, _, _ = groups.closest(o, d)
    for want_h, want_t, want_id in ((bh, bt, btid), (rh, rt, rtid)):
        assert torch.equal(hit, want_h)
        assert torch.equal(tid[hit].long(), want_id[hit].long())
        assert torch.equal(t[hit].view(torch.int32), want_t[hit].view(torch.int32))
    return hit, t, tid


def test_tie_goes_to_the_least_id_whatever_the_walk_order():
    """Two coplanar duplicate triangles (ids 1 and 2) in one leaf whose
    slots are swapped, so that the larger id is walked first: every ray
    through them ties exactly, and the walk answers the smaller id, as the
    brute least (t, id) and the reference do."""
    tri = [(0.5, 0.25, 1.0), (3.25, 0.5, 1.0), (0.75, 2.5, 1.0)]
    far = [(6.0, 6.0, 3.0), (7.0, 6.0, 3.0), (6.0, 7.0, 3.0)]
    scene, groups = _scenes([_mesh("m", [far, tri, tri])])
    pb = bvh.build_bvh(scene, leaf_size=8)
    order = pb.tri_order.clone()
    s1, s2 = (int(torch.nonzero(order == i)[0]) for i in (1, 2))
    perm = torch.arange(order.numel())
    perm[s1], perm[s2] = s2, s1
    pb = dataclasses.replace(pb, tri_order=order[perm].contiguous(),
                             tris=pb.tris[perm].contiguous())
    assert int(pb.tri_order[min(s1, s2)]) == 2            # the larger id first
    rng = np.random.default_rng(5)
    n = 64
    target = np.stack([rng.uniform(0.9, 1.6, n), rng.uniform(0.6, 1.2, n), np.ones(n)], 1)
    o = torch.from_numpy(np.stack([rng.uniform(-1, 4, n), rng.uniform(-1, 4, n),
                                   rng.uniform(3, 5, n)], 1).astype(np.float32))
    d = torch.from_numpy(target.astype(np.float32)) - o
    hit, _, tid = _closest_is_least(pb, scene, groups, o, d)
    assert bool(hit.all()) and bool((tid == 1).all())


def test_hit_on_a_shared_edge_on_a_leaf_box_face():
    """Two triangles share the edge x = 1, each its own leaf (leaf size 1),
    the edge on both leaves' box faces; the one with the larger id is walked
    first.  Rays through the edge hit both at one t: with the build's
    tight boxes the second leaf's entry reaches the best t and the walk
    prunes it, keeping the larger id; padded, the walk answers the least
    (t, id), as the brute search and the reference do."""
    right = [(1.0, 0.0, 0.0), (2.0, 0.0, 0.0), (1.0, 1.0, 0.0)]
    left = [(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (1.0, 1.0, 0.0)]
    scene, groups = _scenes([_mesh("m", [right, left])])
    pb = bvh.build_bvh(scene, leaf_size=1)
    first = int(pb.tri_order[int(pb.leaf_start[1])])
    assert first == 1                                    # the left triangle, the larger id
    ys = np.linspace(0.0625, 0.9375, 15, dtype=np.float32)
    o = torch.from_numpy(np.stack([np.full_like(ys, 0.5), ys, np.ones_like(ys)], 1))
    d = torch.tensor([[0.5, 0.0, -1.0]]).expand(len(ys), 3).contiguous()
    hit, t, tid = _closest_is_least(pb, scene, groups, o, d)
    assert bool(hit.all()) and bool((tid == 0).all()) and bool((t == 1.0).all())
    tight = bvh.bvh_closest(_tight(pb, scene), o, d)
    assert bool((tight[2] == 1).all())                   # the tight walk keeps walk order


def test_shadow_ray_across_an_emissive_quads_diagonal():
    """Shadow rays toward points sampled on one half of an emissive quad,
    at its diagonal, with that half excluded: the other half blocks
    wherever Moller-Trumbore reports its hit just short of tmax.  Padded,
    the walk finds every such blocker the brute search and the reference
    find; with tight boxes the panel's flat box is entered at tmax by
    rounding and the walk misses most of them."""
    y, x0, x1, z0, z1 = 9.25, 4.3, 5.1, 6.7, 7.5
    quad = [[(x0, y, z0), (x1, y, z0), (x1, y, z1)], [(x0, y, z0), (x1, y, z1), (x0, y, z1)]]
    floor = [[(0, 0, 0), (12, 0, 0), (12, 0, 12)], [(0, 0, 0), (12, 0, 12), (0, 0, 12)]]
    scene, groups = _scenes([_mesh("floor", floor), _mesh("lamp", quad, 10.0)])
    pb = bvh.build_bvh(scene, leaf_size=1)
    rng = np.random.default_rng(3)
    n = 1000
    o = torch.from_numpy(np.stack([rng.uniform(0.5, 11.5, n), rng.uniform(0.01, 3.0, n),
                                   rng.uniform(0.5, 11.5, n)], 1).astype(np.float32))
    lv0, lv1, lv2 = scene.tri_v0[2], scene.tri_v1[2], scene.tri_v2[2]
    b0 = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))
    b1 = torch.from_numpy(rng.uniform(0.0, 1e-6, n).astype(np.float32)) * (1.0 - b0)
    point = b0[:, None] * lv0 + b1[:, None] * lv1 + (1.0 - b0 - b1)[:, None] * lv2
    to = point - o
    tmax = torch.sqrt((to * to).sum(dim=1))
    d = to / tmax[:, None]
    excl = torch.full((n,), 2, dtype=torch.int32)
    occ = bvh.bvh_any(pb, o, d, tmax, excl)
    assert torch.equal(occ, _brute(scene, o, d, tmax, excl))
    assert torch.equal(occ, groups.occluded(o, d, tmax, excl.long()))
    tight = bvh.bvh_any(_tight(pb, scene), o, d, tmax, excl)
    assert int(occ.sum()) > 50 and int((occ & ~tight).sum()) > 25
    assert not bool((tight & ~occ).any())


def test_small_atrium_frame_matches_reference():
    """The benchmark's atrium at 2,200 target triangles through ``bvh`` on
    the CPU (64x36, k 3, two passes, the seed of a frame whose shadow rays
    met the tight boxes' faults): every pixel equals the reference's
    render (``benchmarks/drivers/frame.reference_image``), none mismatched."""
    from chiaroscuro_tpu_torch.render.renderer import Renderer

    seed = 1264210757
    cfg = {"name": "atrium_bvh", "scene": {"generator": "atrium", "target_tris": 2200,
                                           "geometry_seed": 0},
           "xres": 64, "yres": 36, "k": 3, "intersector": "bvh",
           "camera": {"eye": [1.8, 4.2, 5.0], "center": [24.0, 3.2, 6.8],
                      "up": [0.0, 1.0, 0.0], "yview": 0.9}}
    tr = {"spp": 1, "limits": {"mismatch_pct": 5.0, "rel_l1_pct": 0.5}}
    meshes, textures = program.scene_inputs(cfg)
    scene, _ = program.port_scene(meshes, textures, "cpu")
    r = Renderer(scene, program.render_config(cfg, 1, seed, "cpu"))
    assert hasattr(r.intersectors[0], "bvh")
    for _ in range(2):
        r.ray_trace()
    pix = np.arange(64 * 36)
    want = frame.reference_image(cfg, tr, seed, "cpu", meshes, textures, pix, r._layers)
    checks = program.image_checks(r.pixels.reshape(-1, 3), want, tr["limits"])
    assert float(want.mean()) > 0
    assert [c.value for c in checks] == [0.0, 0.0]


def test_step_counts_and_cpu_wrappers(built):
    """The wrappers take the plain walk for CPU tensors and count no
    launch; the walk's per-ray counts add up: every ray's steps are at
    least one and at most the cap, and a ray that hit tested at least one
    leaf triangle; B2's tests stop at the blocker."""
    _, sa, _, _, pb = built
    o, d = (torch.from_numpy(x) for x in _rays(sa, 16, n=128))
    before = dict(bvh_cuda.LAUNCHES)
    out = bvh_cuda.closest_bvh(pb, o, d, counts=True)
    ref = bvh.bvh_closest(pb, o, d, counts=True)
    for a, b in zip(out[:5], ref[:5]):
        assert torch.equal(a, b)
    steps, tests = out[5]
    assert torch.equal(steps, ref[5][0]) and torch.equal(tests, ref[5][1])
    assert int(steps.min()) >= 1 and int(steps.max()) <= bvh.step_limit(pb)
    assert bool((tests[out[0]] > 0).all())
    tmax = torch.full((len(o),), 1e30)
    excl = torch.full((len(o),), -1, dtype=torch.int32)
    occ, (asteps, atests) = bvh_cuda.any_bvh(pb, o, d, tmax, excl, counts=True)
    assert torch.equal(occ, out[0])           # no limit, no exclusion: occluded iff hit
    assert bool((asteps <= steps).all()) and bool((atests <= tests).all())
    assert bvh_cuda.LAUNCHES == before
    capped = bvh.bvh_closest(pb, o, d, max_iters=2, counts=True)
    assert int(capped[5][0].max()) <= 2


def test_empty_wavefronts_walk_without_a_launch(built):
    """An empty wavefront walks to empty outputs without a launch."""
    _, _, _, _, pb = built
    before = dict(bvh_cuda.LAUNCHES)
    none = torch.zeros((0, 3))
    hit, t, tid, u, v, (steps, tests) = bvh_cuda.closest_bvh(pb, none, none, counts=True)
    occ = bvh_cuda.any_bvh(pb, none, none, torch.zeros(0), torch.zeros(0, dtype=torch.int32))
    assert hit.shape == t.shape == steps.shape == occ.shape == (0,)
    assert bvh_cuda.LAUNCHES == before


@pytest.mark.parametrize("query", ["closest", "any"])
def test_seen_marks_walked_nodes_and_slots(built, query):
    """``seen`` marks what the walks touch, the bytes the kernels' bound
    counts: a threaded walk visits a node at most once and tests a leaf at
    most once, so for one ray the marked nodes equal its steps and the
    marked slots its leaf tests; for many rays they are the union, at most
    the sums."""
    _, sa, _, _, pb = built
    o, d = (torch.from_numpy(x) for x in _rays(sa, 17, n=64, on_plane=False))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    tmax = torch.full((len(o),), 1e30)
    excl = torch.full((len(o),), -1, dtype=torch.int32)

    def walk(rows):
        seen = (torch.zeros(pb.n_nodes, dtype=torch.bool),
                torch.zeros(pb.tri_order.shape[0], dtype=torch.bool))
        if query == "closest":
            counts = bvh.bvh_closest(pb, o[rows], d[rows], counts=True, seen=seen)[-1]
        else:
            counts = bvh.bvh_any(pb, o[rows], d[rows], tmax[rows], excl[rows], counts=True,
                                 seen=seen)[-1]
        return [int(c.sum()) for c in counts], [int(m.sum()) for m in seen]

    for i in range(8):
        counts, marked = walk(slice(i, i + 1))
        assert counts == marked and counts[0] >= 1
    counts, marked = walk(slice(None))
    assert 1 <= marked[0] <= counts[0] and 1 <= marked[1] <= counts[1]


# ---------------------------------------------------------------------------
# Renders and gradients.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cornell", "cornell_default_view", "atrium2200"])
def test_render_matches_jax_bvh(name):
    """The port's render through ``intersector bvh`` against the JAX
    package's render through its BVH, at the render bound.  Cornell at
    CORNELL_CAMERA and at the config's default view, whose eye lies on two
    walls' planes, so that most primary rays tie at t = 0: there the port's
    BVH takes the least id, where the JAX package's keeps walk order, and
    at that edge-on view the two packages' renders through the least id
    part by XLA's FMAs (ROADMAP section 3, hazards), so the BVH's image is
    held bit for bit against the port's dense pair's (the least (t, id));
    atrium(2_200) at its own view."""
    if name.startswith("cornell"):
        tokens = ["input", "builtin:cornell_box", "xres", "16", "yres", "12", "samples", "4",
                  "k", "2"]
        if name == "cornell":
            tokens += _cam_tokens(CORNELL_CAMERA)
        sa = build_scene_arrays(jax_cornell_box())
    else:
        tokens = ["input", "synthetic:atrium:2200", "xres", "32", "yres", "18", "samples",
                  "2", "k", "2", *_cam_tokens(ATRIUM_CAMERA)]
        sa = build_scene_arrays(jax_atrium(2_200))
    cfg = RenderConfig.from_tokens(tokens + ["platform", "cpu", "intersector", "bvh"])
    img = render_image(_port_scene(sa), cfg).numpy()
    if name == "cornell_default_view":
        dense = RenderConfig.from_tokens(tokens + ["platform", "cpu", "intersector", "dense"])
        ref = render_image(_port_scene(sa), dense).numpy()
        assert float(ref.mean()) > 0.0
        np.testing.assert_array_equal(img, ref)
        return
    jcfg = JaxRenderConfig.from_tokens(tokens)
    ref = np.asarray(jax_render_image(sa, jcfg, intersectors=jax_make_intersectors(sa, "bvh")))
    assert float(ref.mean()) > 0.0
    assert_render_close(img, ref)


def test_auto_above_dense_ceiling_on_cpu_is_bvh(tmp_path):
    """A scene above 4,096 triangles through ``auto`` on the CPU: the port's
    CLI takes the BVH, as the JAX package's ``auto`` does on a CPU backend,
    and its image matches the JAX renderer's (``Renderer`` with ``intersector
    auto``, the JAX CLI's path)."""
    tokens = ["input", "synthetic:atrium:6000", "xres", "32", "yres", "18", "samples", "1",
              "k", "2", "intersector", "auto", *_cam_tokens(ATRIUM_CAMERA)]
    jcfg = JaxRenderConfig.from_tokens(tokens)
    jr = JaxRenderer(jax_load_scene(jcfg), jcfg)
    assert jr.scene.n_tris > 4096
    jr.ray_trace(jcfg.vp, jcfg.la, jcfg.up, jcfg.yview)
    r = cli.run(["chiaroscuro_tpu_torch", "scenes/cornell.rtc", "no-preview", *tokens,
                 "platform", "cpu", "output", str(tmp_path / "a.exr")])
    assert hasattr(r.intersectors[0], "bvh") and not hasattr(r.intersectors[0], "planar_fn")
    assert (tmp_path / "a.exr").exists()
    assert_render_close(r.pixels, np.asarray(jr.pixels))


def _pixels(xres, yres):
    ys, xs = np.meshgrid(np.arange(yres), np.arange(xres), indexing="ij")
    return xs.reshape(-1).astype(np.int32), ys.reshape(-1).astype(np.int32)


def test_material_grads_match_jax():
    """d(mean image)/d(kd, ke) through ``bvh`` against ``jax.grad`` through
    the JAX package's BVH (Cornell 12x12, 2 spp, k 2): relative L1 <= 1e-5.
    Found: kd 1.5e-7, ke 1.1e-7."""
    sa = build_scene_arrays(jax_cornell_box())
    cam = CORNELL_CAMERA
    res, spp, depth = (12, 12), 2, 2
    px, py = _pixels(*res)
    jbv = jbvh.build_bvh(sa)

    def jloss(params):
        s = dataclasses.replace(sa, **params)
        cf, af = jbvh.make_bvh_intersectors(s, jbv)
        img = jax_render_samples(
            s, jnp.asarray(cam["eye"], jnp.float32), jnp.asarray(cam["center"], jnp.float32),
            jnp.asarray(cam["up"], jnp.float32), jnp.float32(cam["yview"]), *res,
            jnp.asarray(px), jnp.asarray(py), jnp.int32(0), spp, jnp.uint32(0), depth,
            jnp.zeros(3, jnp.float32), cf, af,
        )
        return jnp.mean(img)

    fields = ("kd", "ke")
    ref_value, ref = jax.value_and_grad(jloss)({k: getattr(sa, k) for k in fields})
    scene = _port_scene(sa)
    p = params_from_numpy({k: np.asarray(getattr(sa, k)) for k in fields}, "cpu")
    s = scene.replace(**p)
    cf, af = make_intersectors(s, "bvh")
    value = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], *res,
                           torch.from_numpy(px), torch.from_numpy(py), 0, spp, 0, depth,
                           (0.0, 0.0, 0.0), cf, af).mean()
    value.backward()
    np.testing.assert_allclose(float(value.detach()), float(ref_value), rtol=1e-5)
    for k in fields:
        r, g = np.asarray(ref[k]), p[k].grad.numpy()
        assert np.abs(r).sum() > 0, k
        assert np.abs(g - r).sum() <= 1e-5 * np.abs(r).sum(), k


def test_vertex_grad_raises():
    """A scene whose vertices require grad has no gradient through the BVH:
    building its pair raises ValueError naming the BVH and pointing at the
    dense and cluster paths (the JAX package fails there too, on a traced
    vertex array).  So does rendering such a scene through a pair built
    before from the detached scene: the integrator's row path checks the
    scene it is given, rather than return the partial gradient of
    ``tri_v0[tid]`` with u and v held constant."""
    scene = _port_scene(build_scene_arrays(jax_cornell_box()))
    p = params_from_numpy({"tri_v0": scene.tri_v0.numpy()}, "cpu")
    with pytest.raises(ValueError, match="BVH.*'dense' or 'cluster'"):
        make_intersectors(scene.replace(**p), "bvh")
    with pytest.raises(ValueError, match="BVH"):
        bvh.build_bvh(scene.replace(**p))
    cf, af = make_intersectors(scene, "bvh")
    cam = CORNELL_CAMERA
    px, py = _pixels(4, 4)
    with pytest.raises(ValueError, match="BVH.*'dense' or 'cluster'"):
        render_samples(scene.replace(**p), cam["eye"], cam["center"], cam["up"], cam["yview"],
                       4, 4, torch.from_numpy(px), torch.from_numpy(py), 0, 1, 0, 2,
                       (0.0, 0.0, 0.0), cf, af)
