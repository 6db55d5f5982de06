"""The port's tools (``chiaroscuro_tpu_torch/tools/``) against the JAX
package's ``tools/``, on the CPU, with the same numpy-seeded inputs:

- X1: the plain row-hit cull against ``tools/tpu_cull_experiments.py::
  _cull_rowhit_call`` in interpret mode, exactly (padded columns included);
  its drop-in against ``_cull_rows_kernelized``, exactly (overflow rows and
  rows shorter than the list included: that pins the tie order);
- the shootout's formulations against each other and the cull K3;
- X2: the plain block fetch against ``tools/_tpu_dma_min.py::kern`` under
  ``pl.pallas_call(..., interpret=True)`` with the file's own specs.  That
  file runs an un-interpreted ``pallas_call`` at import, so its imports,
  constants and definitions are taken from its source.  The two sum in
  different orders: rtol 2e-6;
- the dense comparison's inputs (``tools/dense_compare.py``): its seeded
  queries and the wavefronts it records from the integrator;
- the BVH comparison (``tools/bvh_compare.py``): the per-lane and per-warp
  bound counts it takes from ``chip_smoke.walk_ops`` against a brute count,
  and its inputs and checks on a small atrium with the plain walk.
"""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu_torch.accel.clusters import build_clusters
from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
from chiaroscuro_tpu_torch.scene.builtin import cornell_box
from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
from chiaroscuro_tpu_torch.render.renderer import render_samples
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.scene_arrays import load_scene
from chiaroscuro_tpu_torch.tools import bvh_compare as bcmp
from chiaroscuro_tpu_torch.tools import cull_experiments as xc
from chiaroscuro_tpu_torch.tools import dense_compare as dcmp
from chiaroscuro_tpu_torch.tools import dma_min as dm
from tools import tpu_cull_experiments as jx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 16


def _random_boxes(rng, K=203):
    lo = rng.uniform(0.0, 0.9, (K, 3))
    hi = lo + rng.uniform(0.01, 0.12, (K, 3))
    return lo.astype(np.float32), hi.astype(np.float32), np.zeros(3), np.ones(3)


def _cornell_boxes():
    """Cornell's clusters at M = 8 (tests/test_cluster.py:308-311)."""
    s = build_scene_tensors(cornell_box(), device="cpu")
    ca = build_clusters(*(x.numpy() for x in (s.tri_v0, s.tri_v1, s.tri_v2)), M=8)
    return ca.bbox_min, ca.bbox_max, s.world_min.numpy(), s.world_max.numpy()


def _case(name, seed=3):
    """(bmin, bmax, o3, d3, tmax) as numpy f32: ROWS rows of seeded rays
    around the boxes' world (tests/test_cluster.py:315-322)."""
    rng = np.random.default_rng(seed)
    bmin, bmax, lo, hi = _random_boxes(rng) if name == "random" else _cornell_boxes()
    n = ROWS * 128
    o = rng.uniform(lo - 0.3 * (hi - lo), hi + 0.3 * (hi - lo), (n, 3))
    d = rng.normal(size=(n, 3))
    d[:5, 0] = 0.0                                      # axis-parallel lanes
    tmax = rng.uniform(0.1, 3.0, (n,)).reshape(ROWS, 128)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return bmin, bmax, f32(o.T.reshape(3, ROWS, 128)), f32(d.T.reshape(3, ROWS, 128)), f32(tmax)


def test_pack_cull_boxes_equals_jax():
    bmin, bmax, *_ = _case("random")
    got = xc.pack_cull_boxes(bmin, bmax)
    np.testing.assert_array_equal(got, jx.pack_cull_boxes(bmin, bmax))
    assert got.shape == (256, 8) and got.dtype == np.float32


@pytest.mark.parametrize("with_tmax", [False, True])
@pytest.mark.parametrize("name", ["random", "cornell"])
def test_x1_plain_equals_interpreted_pallas(name, with_tmax):
    """Exactly equal, padded columns (1.0 in every row) included."""
    bmin, bmax, o3, d3, tmax = _case(name)
    boxes = xc.pack_cull_boxes(bmin, bmax)
    K = bmin.shape[0]
    ref = np.asarray(jx._cull_rowhit_call(
        jnp.asarray(o3), jnp.asarray(d3), jnp.asarray(tmax if with_tmax else 0 * tmax),
        jnp.asarray(boxes), K=K, interpret=True, with_tmax=with_tmax))
    got = xc.cull_rowhit(torch.from_numpy(o3), torch.from_numpy(d3), torch.from_numpy(boxes),
                         torch.from_numpy(tmax) if with_tmax else None)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[:, K:] == 1.0).all()
    if name == "random":       # every row of 128 rays meets all 5 Cornell boxes
        assert 0.05 < ref[:, :K].mean() < 0.95


@pytest.mark.parametrize("with_tmax", [False, True])
def test_x1_dropin_equals_jax(with_tmax):
    """``cull_rows_kernelized`` against ``_cull_rows_kernelized``: meta and
    ids exactly equal at Lmax 24 and 128, over rows that overflow and rows
    with fewer hits than the list is wide."""
    bmin, bmax, o3, d3, tmax = _case("random", seed=4)
    boxes = xc.pack_cull_boxes(bmin, bmax)
    K = bmin.shape[0]
    kinds = set()
    for lmax in (24, 128):
        ref = jx._cull_rows_kernelized(
            jnp.asarray(o3), jnp.asarray(d3), jnp.asarray(boxes), K, lmax, interpret=True,
            tmax=jnp.asarray(tmax) if with_tmax else None)
        got = xc.cull_rows_kernelized(
            torch.from_numpy(o3), torch.from_numpy(d3), torch.from_numpy(boxes), K, lmax,
            tmax=torch.from_numpy(tmax) if with_tmax else None)
        for a, b in zip(got, ref):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        meta = got[0].numpy()
        kinds |= {"overflow" if m[1] else ("short" if m[0] < min(lmax, K) else "full")
                  for m in meta}
    assert {"overflow", "short"} <= kinds, kinds


def test_shootout_formulations_agree():
    """At a tiny scale: the dot-reduce (CK 32, 64), the scan-free
    expression and X1 give K3's hit mask exactly and one (meta, ids); K3's
    lists agree with them on overflow flags, and on trip and id sets where
    a row does not overflow."""
    bmin, bmax, o3, d3, _ = _case("random", seed=5)
    o3, d3 = torch.from_numpy(o3), torch.from_numpy(d3)
    bmin, bmax = torch.from_numpy(bmin), torch.from_numpy(bmax)
    boxes = torch.from_numpy(xc.pack_cull_boxes(bmin.numpy(), bmax.numpy()))
    K, lmax = bmin.shape[0], 40
    want = xc.k3_rowhit(o3, d3, bmin, bmax)
    masks = [xc.rowhit_dot(o3, d3, bmin, bmax, 32), xc.rowhit_dot(o3, d3, bmin, bmax, 64),
             xc.rowhit_dot(o3, d3, bmin, bmax), xc.cull_rowhit(o3, d3, boxes)[:, :K] > 0]
    lists = [xc.old_contract_lists(m, K, lmax) for m in masks]
    for m, (meta, ids) in zip(masks, lists):
        assert torch.equal(m, want)
        assert torch.equal(meta, lists[0][0]) and torch.equal(ids, lists[0][1])
    k3 = cc.cull(o3, d3, bmin, bmax, lmax)
    over = k3[0][:, 1].bool()
    assert torch.equal(over, lists[0][0][:, 1].bool()) and 0 < int(over.sum()) < ROWS
    keep = ~over
    assert torch.equal(k3[0][keep, 0], lists[0][0][keep, 0])
    assert torch.equal(xc._id_sets(*k3[:2], K)[keep], xc._id_sets(*lists[0], K)[keep])


def test_shootout_main_on_cpu(capsys):
    """``main`` end to end at a tiny size on the CPU (the plain versions)."""
    out = xc._shootout(torch.device("cpu"), 2_200, 64, 8)
    assert (out["K"], out["B0"]) == (22, 32) and len(out["ms"]) == 5
    printed = capsys.readouterr().out
    assert "equals K3's" in printed and "X1 equals its plain version" in printed


def _dma_min_source():
    """tools/_tpu_dma_min.py's imports, constant tuple and definitions run
    into a namespace, and its ``pl.pallas_call(...)`` expression with
    ``interpret=True`` added: (namespace, call)."""
    path = os.path.join(REPO, "tools", "_tpu_dma_min.py")
    with open(path) as f:
        tree = ast.parse(f.read())

    def constant_tuple(n):
        return (isinstance(n, ast.Assign) and isinstance(n.value, ast.Tuple)
                and all(isinstance(e, ast.Constant) for e in n.value.elts))

    body = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef)) or constant_tuple(n)]
    ns = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    out = next(n for n in tree.body if isinstance(n, ast.Assign)
               and isinstance(n.targets[0], ast.Name) and n.targets[0].id == "out")
    call = out.value.func                         # pl.pallas_call(kern, ...)
    call.keywords.append(ast.keyword(arg="interpret", value=ast.Constant(True)))
    expr = ast.fix_missing_locations(ast.Expression(body=call))
    return ns, eval(compile(expr, path, "eval"), ns)


@pytest.mark.parametrize("trip", [0, 5, 16, 19])
def test_x2_plain_matches_interpreted_pallas(trip):
    ns, call = _dma_min_source()
    assert (ns["M"], ns["W"], ns["K"]) == (dm.M, dm.W, dm.K)
    x = np.random.default_rng(trip).random((dm.K * dm.M, dm.W), np.float32)
    meta = np.array([[trip, 0]], np.int32)
    ref = np.asarray(call(jnp.asarray(meta), jnp.asarray(x)))
    got = dm.dma_min(torch.from_numpy(meta), torch.from_numpy(x))
    assert got.shape == ref.shape == (1, dm.W)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=0.0)
    if trip == 0:
        assert not ref.any() and not bool(got.any())


def test_x2_main_and_shapes_on_cpu(capsys):
    out, x = dm.main(device="cpu")
    words = capsys.readouterr().out.split()
    assert words[0] == "ok" and float(words[1]) == pytest.approx(float(x.sum()), rel=1e-5)
    assert torch.equal(out, dm.dma_min_plain(torch.tensor([[dm.K, 0]], dtype=torch.int32), x))
    with pytest.raises(ValueError, match="no block"):
        dm.dma_min(torch.tensor([[1, 0]], dtype=torch.int32), torch.zeros((64, dm.W)))


def test_tools_without_a_card_raise():
    """The tools run on the card unless the caller names the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tools run on it")
    with pytest.raises((AssertionError, RuntimeError)):
        dm.main()
    with pytest.raises((AssertionError, RuntimeError)):
        xc.main()
    with pytest.raises(RuntimeError, match="card"):
        dcmp.main(["--root", REPO])


def test_dense_compare_inputs_on_cpu():
    """The comparison's seeded queries are the same for the same seed, with
    about a third of the rows dead; its recorded wavefronts are the
    integrator's first two closest-hit and occlusion queries of sample 0
    (primary rays leave the eye), and the dense pair's plain versions take
    them."""
    cpu = torch.device("cpu")
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    a, b = (dcmp.make_queries(np.random.default_rng(3), lo, hi, 36, cpu) for _ in range(2))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["o3"].shape == (3, dcmp.B0, 128) and a["excl"].dtype == torch.int32
    assert 0.6 < float(a["live"].float().mean()) < 0.73
    assert 0 <= int(a["excl"].min()) and int(a["excl"].max()) < 36
    cfg = RenderConfig.from_rtc(os.path.join(REPO, "scenes", "cornell.rtc"),
                                ["xres", "32", "yres", "32", "platform", "cpu"])
    scene = load_scene(cfg, cpu)
    waves = dcmp.dense_wavefronts(cfg, scene, make_intersectors, render_samples)
    assert list(waves) == ["primary", "bounce", "shadow", "bounce shadow"]
    prim = waves["primary"]
    assert prim["o3"].shape == (3, 8, 128) and bool(prim["live"].all())
    eye = torch.tensor(cfg.vp, dtype=torch.float32)[:, None, None]
    assert torch.equal(prim["o3"], eye.expand_as(prim["o3"]))
    rows = ic._prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    t = ic.closest_dense(prim["live"], prim["o3"], prim["d3"], rows, ic._prep_attrs(scene))[0]
    assert float((t < ic.BIG).float().mean()) > 0.9       # the box encloses the camera's view
    for w in ("shadow", "bounce shadow"):
        q = waves[w]
        assert set(q) == {"live", "o3", "d3", "tmax", "excl"}
        occ = ic.any_dense(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows)
        assert occ.shape == q["tmax"].shape


@pytest.mark.parametrize("order", ["wavefront", "random"])
def test_walk_ops_against_a_brute_count(order):
    """Per lane: 25 operations a step and 54 a test over the rays; per
    warp: each group of 32 rays (in the order given, the last group short)
    pays 32 x its longest walk, and the SIMT efficiency is at most 1."""
    rng = np.random.default_rng(7)
    R = 32 * 9 + 5
    steps = torch.from_numpy(rng.integers(1, 300, R)).to(torch.int32)
    tests = torch.from_numpy(rng.integers(0, 60, R)).to(torch.int32)
    perm = None if order == "wavefront" else torch.from_numpy(rng.permutation(R))
    walk_ops = bcmp.smoke_module().walk_ops
    lane, warp = walk_ops(steps, tests, order=perm)
    s, t = steps.numpy().astype(np.int64), tests.numpy().astype(np.int64)
    if perm is not None:
        s, t = s[perm.numpy()], t[perm.numpy()]
    want_warp = sum(32 * (25 * int(s[i:i + 32].max()) + 54 * int(t[i:i + 32].max()))
                    for i in range(0, R, 32))
    assert lane == 25 * int(s.sum()) + 54 * int(t.sum())
    assert warp == want_warp and lane <= warp
    same = torch.full((64,), 7, dtype=torch.int32)
    assert walk_ops(same, same) == (64 * 79 * 7, 64 * 79 * 7)
    text, d = bcmp.bound_text((steps, tests), torch.from_numpy(rng.permutation(R)))
    assert 0 < d["simt"] <= 1 and 0 < d["simt_random"] <= 1 and "per warp" in text


def test_bvh_compare_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the comparison runs on it")
    with pytest.raises(RuntimeError, match="card"):
        bcmp.main(["--root", REPO])


def test_bvh_compare_inputs_on_cpu(monkeypatch):
    """On a small atrium at 64x32 (the CPU walks the plain version): the
    comparison's wavefronts (chip_smoke.py's, with the pixel-order bounce)
    pass its checks against the plain walk."""
    from chiaroscuro_tpu_torch.accel import bvh as bvh_mod
    from chiaroscuro_tpu_torch.ops import bvh_cuda as bc
    from chiaroscuro_tpu_torch.scene.synthetic import atrium

    monkeypatch.setattr(bcmp, "turns", lambda fn, reps: (fn(), (1.0, [1.0, 1.0]))[1])
    monkeypatch.setattr(bcmp, "ROW_SAMPLE", 3)
    smoke = bcmp.smoke_module()
    monkeypatch.setattr(smoke, "ROW_SAMPLE", 4)
    cpu = torch.device("cpu")
    scene = build_scene_tensors(atrium(2_200, seed=5), device=cpu)
    b = bvh_mod.build_bvh(scene)
    waves, _, _ = smoke.atrium_wavefronts(scene, 64, 32, cpu, pixel_bounce=True)
    rng = np.random.default_rng(1)
    for w in ("primary", "bounce", "shadow", "bounce, pixel order"):
        res = bcmp.measure(bc, bvh_mod, b, waves[w], rng, w)
        assert res["rays"] == 64 * 32
        assert res["lane_us"] <= res["warp_us"] and res["steps_max"] >= res["steps_mean"]
