"""Dense intersection K1/K2: the plain torch versions against the JAX
Pallas kernels, and the wrappers' contract (the CUDA kernels against the
plain versions on a card: tests/test_torch_cuda.py).

The JAX side runs ``make_pallas_intersectors(scene).planar_fn`` in
interpret mode on the CPU, as tests/test_pallas.py does.  Only live rows are
compared: the TPU kernels compute dead rows that share an 8-row tile with a
live one, the port writes sentinels for every dead row.  ``hit`` and
``occluded`` must be equal; ``tid`` equal or a tie in t; the 32 attribute
rows equal where tid agrees (they are copies).  t, u, v agree to rtol 2e-6,
atol 1e-6 where tid agrees, not bitwise: XLA contracts the Moller-Trumbore
products into FMAs on the CPU, torch rounds each op (found: t within
1.3e-6 relative, u and v within 4.8e-7).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.ops.intersect_pallas import make_pallas_intersectors
from chiaroscuro_tpu.scene.builtin import cornell_box as jax_cornell_box
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors, resolve_auto
from chiaroscuro_tpu_torch.geometry.intersect import (
    intersect_any_bruteforce,
    intersect_closest_bruteforce,
)
from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    scene_tensors_from_numpy,
)

B0 = 13                      # not a multiple of the TPU's 8-row tile
DEAD = [2, 8, 9, 10, 11, 12]  # row 2 shares a tile with live rows; 8-12 fill one


def _soup(n, seed):
    """A JAX SceneArrays of n random small triangles in the unit cube."""
    rng = np.random.default_rng(seed)
    sa = build_scene_arrays(jax_cornell_box())
    v0 = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rep = {
        "tri_v0": v0,
        "tri_v1": v0 + rng.normal(scale=0.15, size=(n, 3)).astype(np.float32),
        "tri_v2": v0 + rng.normal(scale=0.15, size=(n, 3)).astype(np.float32),
    }
    for k in ("normal", "kd", "ke", "ks"):
        rep[k] = rng.uniform(size=(n, 3)).astype(np.float32)
    for k in ("uv0", "uv1", "uv2"):
        rep[k] = rng.uniform(size=(n, 2)).astype(np.float32)
    rep["shininess"] = rng.uniform(1, 50, n).astype(np.float32)
    rep["brdf_type"] = rng.integers(0, 2, n).astype(np.int32)
    for k in ("tex_id", "tex_id_ks", "tex_id_bump"):
        rep[k] = rng.integers(-1, 3, n).astype(np.int32)
    rep = {k: jnp.asarray(v) for k, v in rep.items()}
    return dataclasses.replace(sa, n_tris=n, **rep)


SCENES = {"cornell": lambda: build_scene_arrays(jax_cornell_box()),
          "soup300": lambda: _soup(300, 7)}


def _port_scene(sa):
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    return scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")


def _queries(sa, seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([np.asarray(sa.tri_v0), np.asarray(sa.tri_v1)])
    lo, hi = pts.min(0), pts.max(0)
    ext = (hi - lo)[:, None, None]
    o = rng.uniform(lo[:, None, None] - 0.1 * ext, hi[:, None, None] + 0.1 * ext, (3, B0, 128))
    d = rng.normal(size=(3, B0, 128))
    tmax = rng.uniform(0, 1.5 * (hi - lo).max(), (B0, 128))
    excl = rng.integers(0, sa.n_tris, (B0, 128))
    live = np.ones((B0, 1), np.int32)
    live[DEAD] = 0
    return dict(o3=o.astype(np.float32), d3=d.astype(np.float32),
                tmax=tmax.astype(np.float32), excl=excl.astype(np.int32), live=live)


@pytest.fixture(scope="module", params=sorted(SCENES))
def case(request):
    sa = SCENES[request.param]()
    q = _queries(sa, 3)
    jc, ja = make_pallas_intersectors(sa, interpret=True)
    j = {k: jnp.asarray(v) for k, v in q.items()}
    ref = jc.planar_fn(j["o3"], j["d3"], live=j["live"])
    ref_occ = ja.planar_fn(j["o3"], j["d3"], j["tmax"], j["excl"], live=j["live"])
    return sa, _port_scene(sa), {k: torch.from_numpy(v) for k, v in q.items()}, ref, ref_occ


def test_plain_closest_matches_pallas(case):
    sa, scene, q, ref, _ = case
    rows = ic._prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    attrs = ic._prep_attrs(scene)
    t, tid, u, v, am = ic.closest_dense_plain(q["live"].reshape(-1), q["o3"], q["d3"], rows, attrs)
    live = q["live"].numpy().reshape(-1).astype(bool)
    hit = t.numpy() < ic.BIG
    rhit = np.asarray(ref.hit)
    np.testing.assert_array_equal(hit[live], rhit[live])
    assert 0.05 < hit[live].mean() < 0.95
    # tid equal, or a tie in t within rtol 1e-6 (tests/test_pallas.py:48-50):
    # Cornell's floor holds coplanar, overlapping triangles.
    hl = hit & live[:, None]
    same = tid.numpy() == np.asarray(ref.tid)
    tie = np.isclose(t.numpy(), np.asarray(ref.t), rtol=1e-6)
    assert (same | tie)[hl].all()
    assert same[hl].mean() > 0.99
    h = hl & same
    for got, r in ((t, ref.t), (u, ref.u), (v, ref.v)):
        np.testing.assert_allclose(got.numpy()[h], np.asarray(r)[h], rtol=2e-6, atol=1e-6)
    # The 32 attribute rows, through the port's unpacking.
    attrs_p = ic.unpack_attrs_planar(am)
    for k, a in attrs_p.items():
        r = np.asarray(ref.attrs[k])
        got = a.numpy()
        np.testing.assert_array_equal(got[..., h], r[..., h], err_msg=k)
    # Dead rows: the sentinels.
    dead = ~live
    assert (t.numpy()[dead] == np.float32(ic.BIG)).all()
    assert (tid.numpy()[dead] == 0).all() and (am.numpy()[:, dead] == 0).all()
    # Misses on live rows: the sentinels too.
    miss = ~hit & live[:, None]
    assert (u.numpy()[miss] == 0).all() and (am.numpy()[:, miss] == 0).all()


def test_plain_any_matches_pallas(case):
    sa, scene, q, _, ref_occ = case
    rows = ic._prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    occ = ic.any_dense_plain(q["live"].reshape(-1), q["o3"], q["d3"], q["tmax"], q["excl"], rows)
    live = q["live"].numpy().reshape(-1).astype(bool)
    np.testing.assert_array_equal(occ.numpy()[live], np.asarray(ref_occ)[live])
    assert 0.05 < occ.numpy()[live].mean() < 0.95
    assert not occ.numpy()[~live].any()


def test_wrappers_take_plain_versions_on_cpu(case):
    """The wrappers equal the plain versions on CPU tensors and launch no
    kernel."""
    _, scene, q, _, _ = case
    before = dict(ic.LAUNCHES)
    cf, af = make_intersectors(scene, "auto")
    assert cf.accepts_live and af.accepts_live
    res = cf.planar_fn(q["o3"], q["d3"], live=q["live"])
    occ = af.planar_fn(q["o3"], q["d3"], q["tmax"], q["excl"], live=q["live"])
    rows = ic._prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    plain = ic.closest_dense_plain(q["live"].reshape(-1), q["o3"], q["d3"], rows,
                                   ic._prep_attrs(scene))
    assert torch.equal(res.t, plain[0]) and torch.equal(res.tid, plain[1])
    assert torch.equal(occ, ic.any_dense_plain(q["live"].reshape(-1), q["o3"], q["d3"],
                                               q["tmax"], q["excl"], rows))
    assert ic.LAUNCHES == before == {"closest": 0, "any": 0}


def test_row_major_interface_matches_brute_oracle():
    """closest_fn/any_fn on (R, 3) rows with R not a multiple of 128."""
    scene = _port_scene(SCENES["cornell"]())
    rng = np.random.default_rng(4)
    lo, hi = scene.world_min.numpy(), scene.world_max.numpy()
    o = torch.from_numpy(rng.uniform(lo, hi, (300, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    cf, af = make_intersectors(scene, "dense")
    res = cf(o, d)
    tris = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    hit, t, tid, _, _ = intersect_closest_bruteforce(o, d, *tris)
    assert torch.equal(res.hit, hit) and res.attrs["kd"].shape == (300, 3)
    torch.testing.assert_close(res.t[hit], t[hit], rtol=1e-5, atol=0)
    assert torch.equal(res.attrs["btype"][hit], scene.brdf_type[tid[hit].long()])
    tmax = torch.full((300,), 400.0)
    excl = torch.zeros(300, dtype=torch.int32)
    assert torch.equal(af(o, d, tmax, excl), intersect_any_bruteforce(o, d, *tris, tmax, excl))


def test_wrapper_checks_inputs():
    """Shapes, types and layout are checked.  K1's wrapper is
    differentiable (the closest-hit Function); K2 takes its inputs
    detached."""
    scene = _port_scene(SCENES["cornell"]())
    rows = ic._prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    attrs = ic._prep_attrs(scene)
    o3 = torch.zeros(3, 2, 128)
    t, tid, u, _, am = ic.closest_dense(None, o3.clone().requires_grad_(), o3, rows, attrs)
    assert t.requires_grad and am.requires_grad and not tid.requires_grad
    occ = ic.any_dense(None, o3.clone().requires_grad_(), o3, torch.zeros(2, 128),
                       torch.zeros(2, 128, dtype=torch.int32), rows.clone().requires_grad_())
    assert occ.dtype == torch.bool and not occ.requires_grad
    with pytest.raises(ValueError, match="dtype"):
        ic.closest_dense(None, o3.double(), o3, rows, attrs)
    with pytest.raises(ValueError, match="shape"):
        ic.any_dense(None, o3, o3, torch.zeros(2, 64), torch.zeros(2, 64, dtype=torch.int32), rows)
    with pytest.raises(ValueError, match="contiguous"):
        ic.closest_dense(None, torch.zeros(3, 128, 2).transpose(1, 2), o3, rows, attrs)
    with pytest.raises(ValueError, match="live"):
        ic.closest_dense(torch.ones(3), o3, o3, rows, attrs)


def test_auto_dispatch_by_scene_size():
    assert resolve_auto(36, on_gpu=True) == "dense"
    assert resolve_auto(4096, on_gpu=False) == "dense"
    assert resolve_auto(4097, on_gpu=True) == "cluster"
    assert resolve_auto(481_208, on_gpu=True) == "cluster"
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        resolve_auto(2**24, on_gpu=True)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        resolve_auto(480_000, on_gpu=False)
    scene = _port_scene(SCENES["cornell"]())
    with pytest.raises(NotImplementedError):
        make_intersectors(scene, "bvh")
    with pytest.raises(ValueError):
        make_intersectors(scene, "nope")


@pytest.mark.parametrize("method", ["pallas", "bvh"])
def test_jax_intersector_names(method):
    """The JAX package's intersector names in a ``.rtc``: ``pallas`` (its
    dense Pallas sweep, which K1/K2 port) selects the dense pair and renders
    a Cornell image bitwise equal to ``dense``; ``bvh`` is not ported yet
    and raises (ROADMAP item 10)."""
    from chiaroscuro_tpu_torch.render.renderer import render_image
    from chiaroscuro_tpu_torch.scene.config import RenderConfig

    scene = _port_scene(SCENES["cornell"]())
    if method == "bvh":
        with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
            make_intersectors(scene, method)
        return
    tokens = ["input", "builtin:cornell_box", "xres", "16", "yres", "12", "samples", "2",
              "k", "2", "platform", "cpu"]
    imgs = {m: render_image(scene, RenderConfig.from_tokens(tokens + ["intersector", m]))
            for m in (method, "dense")}
    assert float(imgs["dense"].max()) > 0.0
    assert torch.equal(imgs[method], imgs["dense"])
