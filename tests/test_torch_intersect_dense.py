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


def _ties(n, seed):
    """A soup of n triangles whose geometry is that of its first n // 2,
    twice over: ids i and i + n // 2 tie exactly in t, u and v, and their
    attribute rows differ, so the attributes show which id won."""
    sa = _soup(n, seed)
    half = n // 2
    rep = {k: jnp.concatenate([getattr(sa, k)[:half]] * 2)
           for k in ("tri_v0", "tri_v1", "tri_v2")}
    return dataclasses.replace(sa, **rep)


SCENES = {"cornell": lambda: build_scene_arrays(jax_cornell_box()),
          "soup300": lambda: _soup(300, 7),
          "ties": lambda: _ties(300, 8)}


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
    half = sa.n_tris // 2
    if np.array_equal(np.asarray(sa.tri_v0[:half]), np.asarray(sa.tri_v0[half:2 * half])):
        # Exact ties (the "ties" scene): both pick the lower of two ids.
        assert same[hl].all() and (tid.numpy()[hl] < half).all()
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
    res = cf.planar_fn(q["o3"], q["d3"], live=q["live"])
    occ = af.planar_fn(q["o3"], q["d3"], q["tmax"], q["excl"], live=q["live"])
    rows = ic._prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    plain = ic.closest_dense_plain(q["live"].reshape(-1), q["o3"], q["d3"], rows,
                                   ic._prep_attrs(scene))
    assert torch.equal(res.t, plain[0]) and torch.equal(res.tid, plain[1])
    assert torch.equal(occ, ic.any_dense_plain(q["live"].reshape(-1), q["o3"], q["d3"],
                                               q["tmax"], q["excl"], rows))
    assert ic.LAUNCHES == before == {"closest": 0, "any": 0}


def test_kernel_table_holds_the_rows_and_is_made_once_a_pair(monkeypatch):
    """The kernels' padded (T, 12) table holds exactly the (T, 9) rows
    v0|e1|e2, with zeros between, detached; the intersector pair makes it
    once, not once a query."""
    sa = _soup(300, 7)
    scene = _port_scene(sa)
    rows = ic._prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    table = ic.pad_table(rows.clone().requires_grad_())
    assert table.shape == (300, 12) and table.dtype == torch.float32
    assert table.is_contiguous() and not table.requires_grad
    tri = table.reshape(300, 3, 4)
    assert torch.equal(tri[:, :, :3].reshape(300, 9), rows)
    assert torch.equal(tri[:, :, 3], torch.zeros(300, 3))
    assert ic.pad_table(rows[:0]).shape == (0, 12)

    made, passed = [], []
    real = {k: getattr(ic, k) for k in ("pad_table", "closest_dense", "any_dense")}

    def counting(tri_rows):
        made.append(real["pad_table"](tri_rows))
        return made[-1]

    def closest(*args):
        passed.append(args[5])
        return real["closest_dense"](*args)

    def any_(*args):
        passed.append(args[6])
        return real["any_dense"](*args)

    monkeypatch.setattr(ic, "pad_table", counting)
    monkeypatch.setattr(ic, "closest_dense", closest)
    monkeypatch.setattr(ic, "any_dense", any_)
    cf, af = make_intersectors(scene, "dense")
    q = {k: torch.from_numpy(v) for k, v in _queries(sa, 5).items()}
    for _ in range(2):
        cf.planar_fn(q["o3"], q["d3"], live=q["live"])
        af.planar_fn(q["o3"], q["d3"], q["tmax"], q["excl"], live=q["live"])
    assert len(made) == 1 and len(passed) == 4
    assert all(t is made[0] for t in passed)
    assert torch.equal(made[0], table)


def _brute_reject_counts(live, o3, d3, rows, tmax=None, excl=None, per_warp=False):
    """reject_counts by loops over groups of 32 lanes, lanes and triangles,
    each test in numpy float32 in the kernels' operand order."""
    f32 = np.float32
    o = o3.numpy().reshape(3, -1).T
    d = d3.numpy().reshape(3, -1).T
    tri = rows.numpy()
    T, R = tri.shape[0], o.shape[0]

    def test(lane, j):
        (ox, oy, oz), (dx, dy, dz) = o[lane], d[lane]
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri[j]
        px, py, pz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
        a = e1x * px + e1y * py + e1z * pz
        nonpar = abs(a) >= f32(ic.FLT_EPS)
        f = f32(1.0) / (a if nonpar else f32(1.0))
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        u = f * (sx * px + sy * py + sz * pz)
        qx, qy, qz = sy * e1z - sz * e1y, sz * e1x - sx * e1z, sx * e1y - sy * e1x
        v = f * (dx * qx + dy * qy + dz * qz)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        u_ok = nonpar and f32(0) <= u <= f32(1)
        return u_ok, u_ok and v >= 0 and u + v <= 1 and t >= 0, t

    last = {}
    for lane in range(R):
        last[lane] = T - 1
        if tmax is not None:
            for j in range(T):
                _, ok, t = test(lane, j)
                if ok and t < tmax.reshape(-1)[lane] and j != int(excl.reshape(-1)[lane]):
                    last[lane] = j
                    break
    full = front = 0
    for g in range(0, R, 32):
        if not int(live[g // 128]):
            continue
        for j in range(T):
            voters = [lane for lane in range(g, g + 32) if j <= last[lane]]
            lanes = voters
            if per_warp:
                lanes = list(range(g, g + 32)) if voters else []
            vote = any(test(lane, j)[0] for lane in voters)
            full += len(lanes) if vote else 0
            front += 0 if vote else len(lanes)
    return full, front


@pytest.mark.parametrize("kind", ["closest", "any", "any per warp"])
def test_reject_counts_match_a_brute_count(kind):
    """The count of tests the warp-uniform reject leaves (the kernels'
    bound) against a brute count, on Cornell with coherent and random rays,
    a dead row, closest and occlusion queries."""
    scene = _port_scene(SCENES["cornell"]())
    rows = ic._prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    rng = np.random.default_rng(11)
    lo, hi = scene.world_min.numpy(), scene.world_max.numpy()
    o3 = rng.uniform(lo[:, None, None], hi[:, None, None], (3, 3, 128)).astype(np.float32)
    d3 = rng.normal(size=(3, 3, 128)).astype(np.float32)
    o3[:, 0] = np.array([278.0, 273.0, -800.0], np.float32)[:, None]   # a camera's row
    d3[:, 0] = np.stack([np.linspace(-0.3, 0.3, 128), np.full(128, 0.05),
                         np.ones(128)]).astype(np.float32)
    live = torch.tensor([1, 1, 0], dtype=torch.int32)
    o3, d3 = torch.from_numpy(o3), torch.from_numpy(d3)
    tmax = excl = None
    if kind != "closest":
        tmax = torch.from_numpy(rng.uniform(0, 1500, (3, 128)).astype(np.float32))
        excl = torch.from_numpy(rng.integers(-1, 36, (3, 128)).astype(np.int32))
    per_warp = kind == "any per warp"
    got = ic.reject_counts(live, o3, d3, rows, tmax, excl, per_warp=per_warp)
    assert got == _brute_reject_counts(live, o3, d3, rows, tmax, excl, per_warp)
    assert got[0] > 0 and got[1] > 0
    if kind == "closest":
        assert sum(got) == 2 * 128 * 36


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
    """``auto`` follows the JAX package above 4,096 triangles: cluster on a
    GPU below 2^24 triangles, the BVH on the CPU, and the BVH with a
    ``RuntimeWarning`` on a GPU at 2^24 or more."""
    import warnings

    assert resolve_auto(36, on_gpu=True) == "dense"
    assert resolve_auto(4096, on_gpu=False) == "dense"
    assert resolve_auto(4097, on_gpu=True) == "cluster"
    assert resolve_auto(481_208, on_gpu=True) == "cluster"
    with pytest.warns(RuntimeWarning, match="2\\^24"):
        assert resolve_auto(2**24, on_gpu=True) == "bvh"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_auto(4097, on_gpu=False) == "bvh"
        assert resolve_auto(480_000, on_gpu=False) == "bvh"
    scene = _port_scene(SCENES["cornell"]())
    with pytest.raises(ValueError):
        make_intersectors(scene, "nope")


@pytest.mark.parametrize("method", ["pallas", "bvh"])
def test_jax_intersector_names(method):
    """The JAX package's intersector names in a ``.rtc``: ``pallas`` (its
    dense Pallas sweep, which K1/K2 port) selects the dense pair, and
    ``bvh`` (the threaded BVH) its walk; each renders a Cornell image
    bitwise equal to ``dense``'s at the config's default view, whose eye
    lies on two walls' planes, where most primary rays tie at t = 0: the
    BVH's walk takes the least (t, id), as the dense pair does, and forms
    the hit point as the planar path does (ROADMAP section 3)."""
    from chiaroscuro_tpu_torch.render.renderer import render_image
    from chiaroscuro_tpu_torch.scene.config import RenderConfig

    scene = _port_scene(SCENES["cornell"]())
    tokens = ["input", "builtin:cornell_box", "xres", "16", "yres", "12", "samples", "2",
              "k", "2", "platform", "cpu"]
    imgs = {m: render_image(scene, RenderConfig.from_tokens(tokens + ["intersector", m]))
            for m in (method, "dense")}
    assert float(imgs["dense"].max()) > 0.0
    assert torch.equal(imgs[method], imgs["dense"])
