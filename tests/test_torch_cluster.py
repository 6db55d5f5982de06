"""The cluster path on the CPU: the plain K3 cull and the plain K4-K7 visits
against the JAX package and the brute oracle, and the intersector contract
(the Triton/CUDA kernels against these plain versions on a card:
tests/test_torch_cuda.py).

Both packages cull and visit the very same clusters: the JAX
``build_clusters`` output is read out as numpy and carried into the port
with ``cluster_arrays_from_numpy`` (and the port's own copy is checked equal
to it).  Tolerances:

- the cull (meta, ids, nears, cutoff): exact — (c - o) * inv, min/max and
  compares have no multiply-add for XLA to contract;
- the visits against JAX's interpreted streaming and resident kernels
  (one plain version serves both routes): hit and occluded equal, ids equal or a tie in t, attributes exact where ids agree, t to
  rtol 2e-6 (the dense kernels' bound, tests/test_torch_intersect_dense.py;
  found here 9.0e-7) and u, v to atol 5e-6 (found 2.4e-6, above the 4.8e-7
  found for the dense kernels on Cornell: XLA contracts the
  Moller-Trumbore products into FMAs on the CPU and torch rounds each op,
  and the atrium's metre-scale walls make the cancellation in u and v
  larger; JAX's own brute oracle and cluster kernel differ by 1.3e-6 there);
- against the port's brute oracle: hit and occluded equal, ids equal or
  t-ties, t to rtol 1e-5 (tests/test_cluster.py's bound).
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.accel.clusters import build_clusters as jax_build_clusters
from chiaroscuro_tpu.ops.cluster_pallas import _cull_rows as jax_cull_rows
from chiaroscuro_tpu.ops.cluster_pallas import (
    make_cluster_intersectors as jax_make_cluster_intersectors,
)
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu.scene.synthetic import atrium as jax_atrium
from chiaroscuro_tpu_torch.accel.clusters import (
    build_clusters,
    cluster_arrays_from_numpy,
)
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.geometry.intersect import (
    intersect_any_bruteforce,
    intersect_closest_bruteforce,
)
from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
from chiaroscuro_tpu_torch.render.integrator import texture_kd_lookup
from chiaroscuro_tpu_torch.scene.builtin import cornell_box
from chiaroscuro_tpu_torch.scene.obj_loader import Mesh
from chiaroscuro_tpu_torch.scene.synthetic import atrium
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    build_scene_tensors,
    scene_tensors_from_numpy,
)

M = 32


def _port_scene(sa):
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    return scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")


def _soup_scene(rng, T, spread=4.0, size=0.6):
    """tests/test_cluster.py's random soup, as a port scene."""
    v0 = rng.uniform(-spread, spread, (T, 3)).astype(np.float32)
    v1 = v0 + rng.normal(scale=size, size=(T, 3)).astype(np.float32)
    v2 = v0 + rng.normal(scale=size, size=(T, 3)).astype(np.float32)
    verts = np.stack([v0, v1, v2], axis=1).reshape(-1, 3)
    mesh = Mesh(
        name="soup", positions=verts, normals=np.zeros_like(verts),
        uvs=np.zeros((3 * T, 2), np.float32),
        indices=np.arange(3 * T, dtype=np.int32).reshape(-1, 3),
        diffuse=np.array([0.5, 0.5, 0.5], np.float32),
        emissive=np.zeros(3, np.float32), ambient=np.zeros(3, np.float32),
        specular=np.zeros(3, np.float32), shininess=0.0,
    )
    return build_scene_tensors([mesh], device="cpu")


def _rows(rng, n, lo, hi, pad=0.1):
    ext = hi - lo
    o = rng.uniform(lo - pad * ext, hi + pad * ext, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _planar(x):
    return x.T.reshape(3, -1, 128).contiguous()


@pytest.fixture(scope="module")
def atrium_case():
    """atrium(2_200, seed=5) in both packages, the JAX clusters at M = 32,
    and 4 rows of rays inside the hall with shadow limits."""
    sa = build_scene_arrays(jax_atrium(2_200, seed=5))
    scene = _port_scene(sa)
    jca = jax_build_clusters(np.asarray(sa.tri_v0), np.asarray(sa.tri_v1),
                             np.asarray(sa.tri_v2), M)
    rng = np.random.default_rng(11)
    lo, hi = scene.world_min.numpy(), scene.world_max.numpy()
    o, d = _rows(rng, 4 * 128, lo, hi, pad=-0.05)
    tmax = torch.from_numpy(rng.uniform(0.5, 12.0, (4, 128)).astype(np.float32))
    excl = torch.from_numpy(rng.integers(0, scene.n_tris, (4, 128)).astype(np.int32))
    return sa, scene, jca, _planar(o), _planar(d), tmax, excl


def test_build_clusters_equals_jax(atrium_case, rng):
    sa, _, jca, *_ = atrium_case
    v = [np.asarray(getattr(sa, k)) for k in ("tri_v0", "tri_v1", "tri_v2")]
    soup = [rng.uniform(-4, 4, (333, 3)).astype(np.float32) for _ in range(3)]
    for args, m in ((v, M), (v, 128), (soup, 16)):
        got = build_clusters(*args, M=m)
        ref = jax_build_clusters(*args, M=m)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
    bridged = cluster_arrays_from_numpy(dataclasses.asdict(jca))
    np.testing.assert_array_equal(bridged.orig_id, jca.orig_id)
    assert (bridged.K, bridged.M) == (jca.K, jca.M) == (85, M)


@pytest.mark.parametrize("lmax", [4, cc.DEFAULT_LMAX])
@pytest.mark.parametrize("with_tmax", [False, True])
def test_plain_cull_equals_jax(atrium_case, lmax, with_tmax):
    """Exact in meta, ids, nears and cutoff; Lmax = 4 overflows rows."""
    _, _, jca, o3, d3, tmax, _ = atrium_case
    tm = tmax if with_tmax else None
    Le = min(lmax, jca.K)
    got = cc.cull(o3, d3, torch.from_numpy(jca.bbox_min),
                  torch.from_numpy(jca.bbox_max), Le, tmax=tm)
    ref = jax_cull_rows(jnp.asarray(o3.numpy()), jnp.asarray(d3.numpy()),
                        jca.bbox_min, jca.bbox_max, lmax,
                        tmax=None if tm is None else jnp.asarray(tm.numpy()))
    for name, a, b in zip(("meta", "ids", "nears", "cutoff"), got, ref):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    meta = got[0].numpy()
    assert (meta[:, 0] > 0).all()
    if lmax == 4:
        assert meta[:, 1].all()           # every row overflows
    else:
        assert not meta[:, 1].any() and np.isinf(got[3].numpy()).all()


@pytest.fixture(scope="module", params=[4, None])
def visits(request, atrium_case):
    """Both packages' streaming intersectors over the same clusters."""
    sa, scene, jca, o3, d3, tmax, excl = atrium_case
    lmax = request.param
    jcf, jaf = jax_make_cluster_intersectors(
        sa, M=M, Lmax=lmax, interpret=True, stream=True, clusters=jca)
    j = {k: jnp.asarray(v.numpy()) for k, v in
         dict(o3=o3, d3=d3, tmax=tmax, excl=excl).items()}
    ref = jcf.planar_fn(j["o3"], j["d3"])
    ref_occ = jaf.planar_fn(j["o3"], j["d3"], j["tmax"], j["excl"])
    cf, af = cc.make_cluster_intersectors(
        scene, Lmax=lmax, clusters=cluster_arrays_from_numpy(dataclasses.asdict(jca)))
    got = cf.planar_fn(o3, d3)
    occ = af.planar_fn(o3, d3, tmax, excl)
    return scene, got, occ, ref, ref_occ


def test_plain_closest_visit_matches_jax(visits):
    _, got, _, ref, _ = visits
    hit = got.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    assert 0.9 < hit.mean()
    same = got.tid.numpy() == np.asarray(ref.tid)
    tie = np.isclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-6)
    assert (same | tie)[hit].all() and same[hit].mean() > 0.99
    h = hit & same
    np.testing.assert_allclose(got.t.numpy()[h], np.asarray(ref.t)[h], rtol=2e-6)
    for a, b in ((got.u, ref.u), (got.v, ref.v)):
        np.testing.assert_allclose(a.numpy()[h], np.asarray(b)[h], rtol=0, atol=5e-6)
    for k, a in got.attrs.items():
        np.testing.assert_array_equal(a.numpy()[..., h], np.asarray(ref.attrs[k])[..., h],
                                      err_msg=k)
    # Misses carry the sentinels.
    assert (got.tid.numpy()[~hit] == 0).all() and (got.u.numpy()[~hit] == 0).all()


def test_plain_any_visit_matches_jax(visits):
    _, _, occ, _, ref_occ = visits
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))
    assert 0.05 < occ.numpy().mean() < 0.95


def test_plain_visits_match_brute_oracle(visits, atrium_case):
    scene, got, occ, _, _ = visits
    _, _, _, o3, d3, tmax, excl = atrium_case
    o, d = o3.reshape(3, -1).T, d3.reshape(3, -1).T
    tris = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    hit, t, tid, _, _ = intersect_closest_bruteforce(o, d, *tris)
    assert torch.equal(got.hit.reshape(-1), hit)
    same = got.tid.reshape(-1)[hit] == tid[hit]
    tie = torch.isclose(got.t.reshape(-1)[hit], t[hit], rtol=1e-6)
    assert bool((same | tie).all())
    torch.testing.assert_close(got.t.reshape(-1)[hit], t[hit], rtol=1e-5, atol=0)
    ref = intersect_any_bruteforce(o, d, *tris, tmax.reshape(-1), excl.reshape(-1))
    assert torch.equal(occ.reshape(-1), ref)


def test_derived_buffers_equal_jax(atrium_case):
    """The port's (K, 10, M) blocks hold the JAX packed matrix's geometry
    rows and ids; the attribute table is K1's."""
    sa, scene, jca, *_ = atrium_case
    jcf, _ = jax_make_cluster_intersectors(sa, M=M, interpret=True, clusters=jca)
    _, _, jpacked = jcf.derive_buffers(sa)
    jpacked = np.asarray(jpacked).reshape(jca.K, 48, M)
    packed, attrs = cc.derive_buffers(scene, cluster_arrays_from_numpy(dataclasses.asdict(jca)))
    assert packed.shape == (jca.K, cc.GEO_ROWS, M)
    np.testing.assert_array_equal(packed[:, :9].numpy(), jpacked[:, :9])
    ids = packed[:, 9].contiguous().view(torch.int32).numpy()
    real = jpacked[:, 9] < 2**24
    np.testing.assert_array_equal(ids[real], jpacked[:, 9][real].astype(np.int32))
    assert (ids[~real] == cc.NO_ID).all() and (packed[:, :9].numpy()[~real[:, None, :].repeat(9, 1)] == 0).all()
    assert torch.equal(attrs, ic._prep_attrs(scene))


@pytest.mark.parametrize("lmax", [4, 64])
def test_cluster_closest_matches_oracle(rng, lmax):
    """tests/test_cluster.py: Lmax = 4 forces overflow (the plain version's
    all-K sweep), 64 fits every row."""
    scene = _soup_scene(rng, 300)
    cf, _ = cc.make_cluster_intersectors(scene, M=16, Lmax=lmax)
    o, d = _rows(rng, 300, np.float32(-4.0), np.float32(4.0))
    res = cf(o, d)
    hit, t, tid, u, v = intersect_closest_bruteforce(o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2)
    assert torch.equal(res.hit, hit)
    torch.testing.assert_close(res.t[hit], t[hit], rtol=1e-5, atol=0)
    same = res.tid[hit] == tid[hit]
    assert bool((same | torch.isclose(res.t[hit], t[hit], rtol=1e-6)).all())
    torch.testing.assert_close(res.u[hit][same], u[hit][same], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(res.v[hit][same], v[hit][same], rtol=1e-4, atol=1e-5)


def test_cluster_any_matches_oracle(rng):
    scene = _soup_scene(rng, 300)
    _, af = cc.make_cluster_intersectors(scene, M=16, Lmax=8)
    o, d = _rows(rng, 300, np.float32(-4.0), np.float32(4.0))
    tmax = torch.from_numpy(rng.uniform(0.5, 10.0, 300).astype(np.float32))
    excl = torch.from_numpy(rng.integers(0, 300, 300).astype(np.int32))
    ref = intersect_any_bruteforce(o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2, tmax, excl)
    assert torch.equal(af(o, d, tmax, excl), ref)


def test_cluster_attrs_match_scene_gathers(rng):
    scene = build_scene_tensors(cornell_box(), device="cpu")
    cf, _ = cc.make_cluster_intersectors(scene, M=8, Lmax=16)
    o, d = _rows(rng, 200, scene.world_min.numpy(), scene.world_max.numpy())
    res = cf(o, d)
    tid = res.tid[res.hit].long()
    A = {k: v[res.hit] for k, v in res.attrs.items()}
    assert torch.equal(A["v0"], scene.tri_v0[tid])
    assert torch.equal(A["normal"], scene.normal[tid])
    assert torch.equal(A["kd"], scene.kd[tid]) and torch.equal(A["ke"], scene.ke[tid])
    assert torch.equal(A["btype"], scene.brdf_type[tid])
    assert torch.equal(A["texid"], scene.tex_id[tid])


@pytest.mark.parametrize("lmax", [512, None])
def test_atrium_streaming_matches_oracle(rng, lmax):
    """tests/test_synthetic.py: the shipped streaming configuration against
    the brute oracle, with a textured hit whose atlas fetch differs from the
    flat kd."""
    scene = build_scene_tensors(atrium(2_200, seed=5), device="cpu")
    cf, af = cc.make_cluster_intersectors(scene, M=M, stream=True, Lmax=lmax)
    lo, hi = scene.world_min.numpy(), scene.world_max.numpy()
    o = torch.from_numpy(rng.uniform(lo, hi, (128, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(128, 3)).astype(np.float32))
    ch = cf(o, d)
    oh, ot, _, _, _ = intersect_closest_bruteforce(o, d, scene.tri_v0, scene.tri_v1, scene.tri_v2)
    assert torch.equal(ch.hit, oh)
    torch.testing.assert_close(ch.t[oh], ot[oh], rtol=1e-5, atol=1e-5)
    occ = af(o, d, torch.where(ch.hit, ch.t * 1.5, 1e9), torch.full((128,), -1, dtype=torch.int32))
    assert torch.equal(occ, oh)
    tids = ch.tid[oh].long()
    assert bool((scene.tex_id[tids] >= 0).any())
    texel = texture_kd_lookup(scene, ch.tid.long(), ch.u, ch.v)[oh]
    assert float((texel - scene.kd[tids]).abs().max()) > 0.02


def test_order_hits_sort_is_stable_on_ties():
    """Tied entries keep box-id order (torch.sort(stable=True), as
    lax.sort(is_stable=True)); misses sort last; the cutoff is the first
    entry left off the list."""
    entry = torch.tensor([[2.0, 1.0, 1.0, 3.0, 1.0, 1.0, 1.0, 0.5]])
    hits = torch.tensor([[True, True, True, True, False, True, True, True]])
    meta, ids, nears, cutoff = cc._order_hits(hits, entry, 4)
    assert ids.tolist() == [[7, 1, 2, 5]]
    assert nears.tolist() == [[0.5, 1.0, 1.0, 1.0]]
    assert meta.tolist() == [[4, 1]] and cutoff.tolist() == [[1.0]]
    big = torch.zeros(3, 5000)
    _, sids = torch.sort(big, dim=1, stable=True)
    assert torch.equal(sids, torch.arange(5000).expand(3, 5000))


def test_stream_rule_and_limits():
    """The JAX rule: resident K4/K5 while K x M x 48 x 4 B <= 72 MiB.  The
    sizes of the atrium scenes the port renders (K at M = 128)."""
    assert cc.streams_by_budget(3_760, 128)           # the 481k atrium: 88.1 MiB
    assert not cc.streams_by_budget(22, 128)          # atrium(2_200)
    assert not cc.streams_by_budget(148, 128)         # atrium:19000, 3.5 MiB
    assert not cc.streams_by_budget(2_043, 128)       # atrium:262144, 47.9 MiB
    assert not cc.streams_by_budget(3_072, 128)       # 72.0 MiB: the last resident K
    assert cc.streams_by_budget(3_073, 128)
    small = types.SimpleNamespace(K=22, M=128)
    with pytest.raises(ValueError, match="2\\^24"):
        cc.make_cluster_intersectors(
            types.SimpleNamespace(n_tris=2**24, device=torch.device("cpu")),
            clusters=small)


def test_wrappers_take_plain_versions_on_cpu(atrium_case):
    _, scene, _, o3, d3, tmax, excl = atrium_case
    before = dict(cc.LAUNCHES)
    cf, af = make_intersectors(scene, "cluster")
    assert not cf.prefers_compaction and not cf.prefers_ray_sort
    res = cf.planar_fn(o3, d3)
    af.planar_fn(o3, d3, tmax, excl)
    assert cc.LAUNCHES == before == dict.fromkeys(before, 0)
    assert set(before) == {"cull", "closest_resident", "any_resident",
                           "closest_cluster", "any_cluster"}
    assert res.t.shape == (4, 128) and res.attrs["kd"].shape == (3, 4, 128)


def test_wrapper_checks_inputs(atrium_case):
    """Shapes, types and layout are checked; the cull takes its inputs
    detached (its lists only steer the visits); the visit wrappers take no
    gradient themselves (closest_cluster_diff does)."""
    _, scene, jca, o3, d3, tmax, excl = atrium_case
    bmin, bmax = torch.from_numpy(jca.bbox_min), torch.from_numpy(jca.bbox_max)
    graded = cc.cull(o3.clone().requires_grad_(), d3, bmin, bmax, 8)
    for a, b in zip(graded, cc.cull(o3, d3, bmin, bmax, 8)):
        assert torch.equal(a, b) and not a.requires_grad
    with pytest.raises(ValueError, match="Le="):
        cc.cull(o3, d3, bmin, bmax, 0)
    lists = cc.cull(o3, d3, bmin, bmax, 8)
    packed, attrs = cc.derive_buffers(scene, cluster_arrays_from_numpy(dataclasses.asdict(jca)))
    with pytest.raises(ValueError, match="dtype"):
        cc.any_cluster(*lists, o3, d3, tmax, excl.long(), packed)
    with pytest.raises(ValueError, match="M a multiple of 4"):
        cc.closest_cluster(*lists, o3, d3, packed[..., :30].contiguous(), attrs)
    with pytest.raises(ValueError, match="closest_cluster_diff"):
        cc.closest_cluster(*lists, o3, d3, packed, attrs.clone().requires_grad_())
    with pytest.raises(ValueError, match="closest_cluster_diff"):
        cc.closest_resident(*lists, o3.clone().requires_grad_(), d3, packed, attrs)
    with pytest.raises(ValueError, match="kernels only"):
        cc.closest_resident(*lists, o3, d3, packed, attrs,
                            visits=torch.zeros(o3.shape[1], dtype=torch.int32))


# ---------------------------------------------------------------------------
# The resident route (K4/K5).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[4, None])
def resident_visits(request, atrium_case):
    """JAX's interpreted resident kernels (``stream=False``) and the port's
    resident pair over the same clusters; Lmax 4 overflows every row."""
    sa, scene, jca, o3, d3, tmax, excl = atrium_case
    lmax = request.param
    jcf, jaf = jax_make_cluster_intersectors(
        sa, M=M, Lmax=lmax, interpret=True, stream=False, clusters=jca)
    j = {k: jnp.asarray(v.numpy()) for k, v in
         dict(o3=o3, d3=d3, tmax=tmax, excl=excl).items()}
    ref = jcf.planar_fn(j["o3"], j["d3"])
    ref_occ = jaf.planar_fn(j["o3"], j["d3"], j["tmax"], j["excl"])
    cf, af = cc.make_cluster_intersectors(
        scene, Lmax=lmax, stream=False,
        clusters=cluster_arrays_from_numpy(dataclasses.asdict(jca)))
    assert cf.route == af.route == "resident"
    got = cf.planar_fn(o3, d3)
    occ = af.planar_fn(o3, d3, tmax, excl)
    return scene, got, occ, ref, ref_occ


def test_plain_closest_visit_matches_jax_resident(resident_visits):
    """The plain K4 against JAX's interpreted ``_closest_kernel``, under the
    module's visit tolerances."""
    test_plain_closest_visit_matches_jax(resident_visits)


def test_plain_any_visit_matches_jax_resident(resident_visits):
    test_plain_any_visit_matches_jax(resident_visits)


def test_route_follows_the_stream_rule(atrium_case, monkeypatch):
    """``stream=None`` picks the route by :func:`streams_by_budget` (with
    the budget cut below this scene's matrix for the streaming side),
    ``stream=False`` no longer raises, and either forced route returns the
    same hits."""
    _, scene, jca, o3, d3, _, _ = atrium_case
    ca = cluster_arrays_from_numpy(dataclasses.asdict(jca))
    cf, af = make_intersectors(scene, "cluster", clusters=ca)
    assert cf.route == af.route == "resident"
    res = {}
    for stream in (False, True):
        f, _ = cc.make_cluster_intersectors(scene, clusters=ca, stream=stream)
        assert f.route == ("stream" if stream else "resident")
        res[stream] = f.planar_fn(o3, d3)
    for a, b in zip(res[False][:5], res[True][:5]):
        assert torch.equal(a, b)
    monkeypatch.setattr(cc, "RESIDENT_BUDGET_BYTES", ca.K * ca.M * cc.PACK_W * 4 - 1)
    assert make_intersectors(scene, "cluster", clusters=ca)[0].route == "stream"
