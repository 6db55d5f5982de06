"""The one-hot fetches on the CPU: the closest-hit backward's row fetch
(``intersect_cuda._bwd_fetch``, the JAX package's ``_bwd_fetch``) and the
integrator's light row, each a one-hot product up to a size and a gather
above it.

- The product's values equal the gather's bitwise, up to the sign of a
  zero, while the table is finite (each output sums one 1.0 x value and
  zeros); the tables the renderer fetches from are checked finite here,
  since one non-finite entry would poison every lane (0 x inf = NaN).
- Cornell fwd+bwd w.r.t. (kd, ke, tri_v0) against ``jax.grad`` with the
  JAX package's one-hot fetch forced on: within 1e-5 relative L1 per field
  (found kd 2.4e-7, ke 1.2e-7, tri_v0 1.1e-6) and per entry at
  tests/test_torch_gradients.py's bound; the port's one-hot and gather forms
  within tests/test_gradients.py:252's rtol 1e-5, atol 1e-8 (the same
  values summed in another order).
- The one-hot budget forced small: gradients within 1e-6 relative L1 of the
  one-block product (only the order of the chunks' sums moves); two runs
  bitwise equal.
- The gather's backward, the sort-by-id segmented row sum
  (``ops/scatter_cuda.py``, its plain version on the CPU), against
  ``index_put_(accumulate=True)`` (serial on one thread, as this module
  runs torch): bitwise where no id's lanes cross a 32-item chunk (both sum
  in lane order from 0.0), else within the reassociation bound of a float32
  sum, 2 n eps sum|x| for an entry of n terms; and the gradients of the
  fetch at 2,049 triangles and of the cluster path's gather against JAX's
  VJPs of the same gathers (XLA's scatter-add) within 1e-5 relative, 1e-6
  of the largest entry.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chiaroscuro_tpu.ops.intersect_pallas as ip
from chiaroscuro_tpu.ops.intersect_pallas import make_pallas_intersectors
from chiaroscuro_tpu.render.renderer import render_samples as jax_render_samples
from chiaroscuro_tpu.scene.builtin import cornell_box as jax_cornell_box
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors
from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
from chiaroscuro_tpu_torch.ops import scatter_cuda as sc
from chiaroscuro_tpu_torch.render import integrator
from chiaroscuro_tpu_torch.render.renderer import render_samples
from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA
from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA, atrium
from chiaroscuro_tpu_torch.scene.obj_loader import Mesh
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    build_scene_tensors,
    params_from_numpy,
    scene_tensors_from_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLT_EPS = float(np.finfo(np.float32).eps)
RES = (16, 16)
SPP, DEPTH = 1, 3
FIELDS = ("kd", "ke", "tri_v0")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch ops on one thread, then restore the count:
    its plain versions make many small ops, and with every test worker
    using all the host's cores their threads spin against each other
    (a render that takes 3 s alone took minutes under six workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights():
    return np.linspace(0.5, 1.5, RES[0] * RES[1] * 3, dtype=np.float32).reshape(-1, 3)


@pytest.fixture(scope="module")
def cornell():
    sa = build_scene_arrays(jax_cornell_box())
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    return sa, scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")


def _port_grads(scene, pair=lambda s: make_intersectors(s, "dense")):
    """(loss, {field: grad}) of the weighted mean Cornell image."""
    cam = CORNELL_CAMERA
    ys, xs = torch.meshgrid(torch.arange(RES[1]), torch.arange(RES[0]), indexing="ij")
    params = params_from_numpy({k: getattr(scene, k).numpy() for k in FIELDS}, "cpu")
    s = scene.replace(**params)
    cf, af = pair(s)
    img = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], *RES,
                         xs.reshape(-1), ys.reshape(-1), 0, SPP, 0, DEPTH, (0.0, 0.0, 0.0),
                         cf, af)
    loss = (img * torch.from_numpy(_weights())).mean()
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy() for k, v in params.items()}


def _rel_l1(a, b):
    return float(np.abs(a.astype(np.float64) - b).sum() / np.abs(b.astype(np.float64)).sum())


@pytest.fixture
def count_fetches(monkeypatch):
    """Counts the one-hot fetches of the backward and of the light row."""
    calls = {"bwd": 0, "light": 0}
    fetch = ic.onehot_fetch

    def counted(key):
        def f(mat, idx):
            calls[key] += 1
            return fetch(mat, idx)
        return f

    monkeypatch.setattr(ic, "onehot_fetch", counted("bwd"))
    monkeypatch.setattr(integrator, "onehot_fetch", counted("light"))
    return calls


def test_onehot_equals_gather_up_to_zero_sign():
    """Values bitwise up to a zero's sign, on a table with +-0 entries;
    gradients of both forms agree to float rounding.  A non-finite entry is
    the hazard: the product spreads its NaN to lanes that never pick it."""
    rng = np.random.default_rng(5)
    mat = rng.normal(size=(32, 77)).astype(np.float32)
    mat[:, 3] = 0.0
    mat[:, 4] = -0.0
    mat = torch.from_numpy(mat).requires_grad_()
    tid = torch.from_numpy(rng.integers(0, 77, (5, 128)).astype(np.int32))
    tid[0, :8] = 4
    a, b = ic.onehot_fetch(mat, tid), ic._gather_fetch(mat, tid)
    assert a.shape == b.shape == (32, 5, 128)
    assert torch.equal(a, b)                                   # -0.0 == +0.0
    same_bits = a.view(torch.int32) == b.view(torch.int32)
    assert bool((same_bits | (b == 0)).all())
    ct = torch.from_numpy(rng.normal(size=(32, 5, 128)).astype(np.float32))
    ga, = torch.autograd.grad(a, mat, ct)
    gb, = torch.autograd.grad(b, mat, ct)
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-6)

    bad = mat.detach().clone()
    bad[0, 10] = float("inf")
    picks_10 = (tid == 10)
    assert bool(picks_10.any()) and not bool(picks_10.all())
    assert bool(torch.isnan(ic.onehot_fetch(bad, tid)[0][~picks_10]).all())
    assert bool(torch.isfinite(ic._gather_fetch(bad, tid)[0][~picks_10]).all())


def test_fetched_tables_are_finite(cornell):
    """The one-hot product is exact only on finite tables: Cornell's
    triangle rows, attribute table and light table are."""
    _, scene = cornell
    for table in (ic._prep_tris(scene.tri_v0, scene.tri_v1, scene.tri_v2),
                  ic._prep_attrs(scene), integrator._light_table(scene)):
        assert bool(torch.isfinite(table).all())


def test_cornell_grads_match_jax_onehot(cornell, count_fetches, monkeypatch):
    """The port's default (the one-hot product for both fetches on Cornell:
    36 triangles, 2 lights) against jax.grad with the JAX package's one-hot
    fetch forced on; then the port's gather form against its one-hot form."""
    sa, scene = cornell
    value, grads = _port_grads(scene)
    assert count_fetches["bwd"] > 0 and count_fetches["light"] > 0

    px, py = (np.asarray(x.reshape(-1), np.int32) for x in
              np.meshgrid(np.arange(RES[0]), np.arange(RES[1])))
    cam = CORNELL_CAMERA
    w = jnp.asarray(_weights())

    def loss(params):
        s = dataclasses.replace(sa, **params)
        cf, af = make_pallas_intersectors(s, interpret=True)
        img = jax_render_samples(
            s, jnp.asarray(cam["eye"], jnp.float32), jnp.asarray(cam["center"], jnp.float32),
            jnp.asarray(cam["up"], jnp.float32), jnp.float32(cam["yview"]), *RES,
            jnp.asarray(px), jnp.asarray(py), jnp.int32(0), SPP, jnp.uint32(0), DEPTH,
            jnp.zeros(3, jnp.float32), cf, af)
        return jnp.mean(img * w)

    monkeypatch.setattr(ip, "_BWD_ONEHOT", True)
    ref_value, ref = jax.value_and_grad(loss)({k: getattr(sa, k) for k in FIELDS})
    np.testing.assert_allclose(value, float(ref_value), rtol=1e-5)
    for k in FIELDS:
        r = np.asarray(ref[k])
        assert np.abs(r).max() > 0 and np.isfinite(grads[k]).all(), k
        assert _rel_l1(grads[k], r) <= 1e-5, (k, _rel_l1(grads[k], r))
        np.testing.assert_allclose(grads[k], r, rtol=1e-4, atol=1e-5 * np.abs(r).max(),
                                   err_msg=k)

    monkeypatch.setattr(ic, "_BWD_ONEHOT", False)
    n_bwd = count_fetches["bwd"]
    gather_value, gather = _port_grads(scene)
    assert count_fetches["bwd"] == n_bwd
    assert gather_value == value
    for k in FIELDS:
        np.testing.assert_allclose(gather[k], grads[k], rtol=1e-5, atol=1e-8, err_msg=k)


def test_small_budget_chunks_agree_and_repeat(cornell, monkeypatch):
    """A one-hot budget of 4 KiB cuts each wavefront's fetch into chunks of
    a few lanes: the gradients move by the order of the chunks' sums only,
    and two runs are bitwise equal."""
    _, scene = cornell
    value, grads = _port_grads(scene)
    monkeypatch.setattr(ic, "ONEHOT_BUDGET_BYTES", 4096)
    runs = [_port_grads(scene) for _ in range(2)]
    for k in FIELDS:
        np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k], err_msg=k)
        assert _rel_l1(runs[0][1][k], grads[k]) <= 1e-6, k
    assert runs[0][0] == value


def test_fp32_kept_under_tf32_precision(cornell, monkeypatch):
    """A caller's ``set_float32_matmul_precision("high")`` (TF32 on the
    card) does not reach the fetch: inside it every float32 product is
    IEEE, the caller's setting comes back after, and the gradients equal
    those under "highest" bitwise."""
    _, scene = cornell
    _, want = _port_grads(scene)
    seen = []
    onehots = ic._onehots

    def spy(idx, T):
        for item in onehots(idx, T):       # each chunk's product runs here
            seen.append([m.fp32_precision for m in (torch.backends.cuda.matmul,
                                                    torch.backends.mkldnn.matmul)])
            yield item

    monkeypatch.setattr(ic, "_onehots", spy)
    torch.set_float32_matmul_precision("high")
    try:
        _, got = _port_grads(scene)
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"
    finally:
        torch.set_float32_matmul_precision("highest")
    assert seen and all(p == ["ieee", "ieee"] for p in seen)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("T, onehot", [(2048, True), (2049, False)])
def test_triangle_rule_at_2048(monkeypatch, T, onehot):
    """One-hot up to 2,048 triangles (JAX's padded width is <= 2,048 exactly
    then: 512-triangle chunks), gather above; either way the same values,
    and gradients (the product's, or the gather's segmented sum) against
    the VJP of JAX's ``_bwd_fetch`` at the same size."""
    from chiaroscuro_tpu.ops.intersect_pallas import _tri_chunk_for

    padded = -(-T // _tri_chunk_for(T)) * _tri_chunk_for(T)
    assert (padded <= ip._BWD_ONEHOT_MAX_T) is onehot
    used = []
    fetch = ic.onehot_fetch
    monkeypatch.setattr(ic, "onehot_fetch", lambda m, i: used.append(1) or fetch(m, i))
    mat = torch.arange(9 * T, dtype=torch.float32).reshape(9, T)
    tid = torch.tensor([[0, T - 1] * 64], dtype=torch.int32)
    out = ic._bwd_fetch(mat, tid)
    assert bool(used) is onehot
    assert torch.equal(out, ic._gather_fetch(mat, tid))

    rng = np.random.default_rng(T)
    mat, tid, ct = _fetch_case(rng, 32, T, (6, 128))
    _assert_vjp_matches(ic._bwd_fetch, ip._bwd_fetch, mat, tid, ct)


def _fetch_case(rng, W, T, shape, zero_share=0.6):
    """A (W, T) table, ids with ``zero_share`` of the lanes at id 0 (the
    misses and dead rows of a wavefront), a (W, *shape) cotangent."""
    mat = rng.normal(size=(W, T)).astype(np.float32)
    tid = rng.integers(0, T, shape).astype(np.int32)
    tid[rng.random(shape) < zero_share] = 0
    ct = rng.normal(size=(W, *shape)).astype(np.float32)
    return mat, tid, ct


def _assert_vjp_matches(port_fetch, jax_fetch, mat, tid, ct):
    """The port's fetch gradient against JAX's VJP of ``jax_fetch`` at the
    same table, ids and cotangent: values bitwise, gradients within rtol
    1e-5 and 1e-6 of the largest entry."""
    m = torch.from_numpy(mat).requires_grad_()
    out = port_fetch(m, torch.from_numpy(tid))
    got, = torch.autograd.grad(out, m, torch.from_numpy(ct))
    ref_out, vjp = jax.vjp(lambda x: jax_fetch(x, jnp.asarray(tid)), jnp.asarray(mat))
    ref, = vjp(jnp.asarray(ct))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref_out))
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * scale)


def test_cluster_gather_gradient_matches_jax():
    """The cluster backward's fetch (``_gather_fetch``, as
    ``cluster_pallas.py:1180`` gathers ``attrT_orig[:, tid]``) at W 9 and
    32 over 3,000 rows, 60% of the lanes at id 0: the segmented sum's
    gradient against JAX's scatter-add VJP."""
    rng = np.random.default_rng(11)
    for W in (9, 32):
        mat, tid, ct = _fetch_case(rng, W, 3000, (40, 128))
        _assert_vjp_matches(ic._gather_fetch, lambda m, t: m[:, t], mat, tid, ct)


def _crosses_a_chunk(tid):
    """Whether the lanes of some id span two chunks of the sorted order."""
    keys = np.sort(tid.reshape(-1), kind="stable")
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    ends = np.r_[starts[1:], keys.size] - 1
    return bool((starts // sc.CHUNK != ends // sc.CHUNK).any())


# (width, lanes, rows, ids) cases of the segmented sum: "uniform" ids,
# "skewed" (65% at id 0), "inside" (every id's lanes inside one chunk of
# the sorted order), "span3" (one id on 150 lanes, five chunks and more,
# amid others), ragged lane counts (not a multiple of the 32-item chunk),
# and no lanes at all.
SUM_CASES = {
    "w9_uniform": (9, 4096, 500, "uniform"),
    "w32_uniform": (32, 4096, 500, "uniform"),
    "w9_skewed": (9, 5000, 700, "skewed"),
    "w32_skewed": (32, 20000, 2000, "skewed"),
    "w32_inside": (32, 1024, 64, "inside"),
    "w32_span3": (32, 700, 90, "span3"),
    "w9_ragged": (9, 1001, 37, "uniform"),
    "w32_ragged_skewed": (32, 4133, 300, "skewed"),
    "w32_one_lane": (32, 1, 5, "uniform"),
    "w9_no_lanes": (9, 0, 5, "uniform"),
}


def _sum_case(name):
    W, N, T, kind = SUM_CASES[name]
    rng = np.random.default_rng(len(name) * 1000 + N)
    tid = rng.integers(0, T, N).astype(np.int32)
    if kind == "skewed":
        tid[rng.random(N) < 0.65] = 0
    elif kind == "inside":
        tid = rng.permutation(np.repeat(np.arange(T, dtype=np.int32), N // T))
    elif kind == "span3":
        tid[rng.permutation(N)[:150]] = 7
    ct = rng.normal(size=(W, N)).astype(np.float32)
    return torch.from_numpy(ct), torch.from_numpy(tid), T


@pytest.mark.parametrize("name", list(SUM_CASES))
def test_segmented_sum_equals_index_put(name):
    """The plain segmented sum (what ``scatter_rows_sum`` takes for CPU
    tensors, launching nothing) against ``index_put_(accumulate=True)``:
    bitwise where no id crosses a chunk, else within the float32
    reassociation bound of each entry's sum."""
    ct, tid, T = _sum_case(name)
    W, N = ct.shape[0], tid.numel()
    before = dict(sc.LAUNCHES)
    got = sc.scatter_rows_sum(ct, tid, T)
    assert sc.LAUNCHES == before
    assert torch.equal(got, sc.scatter_rows_sum_plain(ct, tid, T))
    want = torch.zeros((T, W)).index_put_((tid.long(),), ct.T, accumulate=True)
    assert got.shape == (T, W)
    crosses = _crosses_a_chunk(tid.numpy())
    kind = SUM_CASES[name][3]
    if kind in ("skewed", "span3"):
        assert crosses
    if kind == "inside":
        assert not crosses
    if not crosses:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    terms = torch.bincount(tid.long(), minlength=T).double()[:, None]
    mag = torch.zeros((T, W), dtype=torch.float64).index_put_(
        (tid.long(),), ct.T.double().abs(), accumulate=True)
    gap = (got.double() - want.double()).abs()
    assert bool((gap <= 2 * terms * FLT_EPS * mag).all())
    untouched = torch.bincount(tid.long(), minlength=T) == 0
    assert not bool(got[untouched].any())


def test_segmented_sum_takes_levels_down_to_one_chunk():
    """Two slots a chunk at each level until one chunk holds the level:
    the grad cell's wavefront takes five levels."""
    assert sc.level_sizes(0) == [0] and sc.level_sizes(32) == [32]
    assert sc.level_sizes(33) == [33, 4]
    assert sc.level_sizes(921_600) == [921_600, 57_600, 3_600, 226, 16]


@pytest.mark.parametrize("name", ["w32_skewed", "w9_ragged"])
def test_segmented_sum_repeats_bitwise(name):
    """Two runs of the segmented sum give bitwise-equal tables."""
    ct, tid, T = _sum_case(name)
    a, b = (sc.scatter_rows_sum(ct, tid, T) for _ in range(2))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case", ["cluster", "dense_2200"])
def test_gather_backward_runs_the_segmented_sum(monkeypatch, case):
    """The closest hit's backward on the cluster path, and on the dense
    path above 2,048 triangles, sums the gathered rows' cotangents by
    ``scatter_rows_sum``: once a bounce for the attribute table (kd and ke
    take gradients, the triangle rows none)."""
    calls = []
    real = ic.scatter_rows_sum
    monkeypatch.setattr(ic, "scatter_rows_sum",
                        lambda ct, tid, n: calls.append(ct.shape[0]) or real(ct, tid, n))
    scene = build_scene_tensors(atrium(2_200, seed=5), device="cpu")
    assert scene.n_tris > ic.BWD_ONEHOT_MAX_T
    kd = scene.kd.clone().requires_grad_()
    ke = scene.ke.clone().requires_grad_()
    s = scene.replace(kd=kd, ke=ke)
    cf, af = make_intersectors(s, "cluster" if case == "cluster" else "dense")
    ys, xs = torch.meshgrid(torch.arange(8), torch.arange(8), indexing="ij")
    cam, depth = ATRIUM_CAMERA, 2
    img = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], 8, 8,
                         xs.reshape(-1), ys.reshape(-1), 0, 1, 3, depth, (0.0, 0.0, 0.0),
                         cf, af)
    img.mean().backward()
    assert calls == [ic.ATTR_K] * depth
    assert float(ke.grad.abs().sum()) > 0


def _light_soup(n_lights):
    """n_lights emissive triangles over a diffuse floor."""
    rng = np.random.default_rng(n_lights)
    v0 = rng.uniform(-1.0, 1.0, (n_lights, 3)).astype(np.float32)
    v0[:, 1] = 2.0
    verts = np.stack([v0, v0 + [0.05, 0.0, 0.0], v0 + [0.0, 0.0, 0.05]], 1).astype(np.float32)
    floor = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32)

    def mesh(name, pos, idx, ke, up):
        normals = np.tile(np.array([0.0, up, 0.0], np.float32), (len(pos), 1))
        return Mesh(name=name, positions=pos, normals=normals,
                    uvs=np.zeros((len(pos), 2), np.float32), indices=idx,
                    diffuse=np.array([0.5, 0.5, 0.5], np.float32),
                    emissive=np.array(ke, np.float32), ambient=np.zeros(3, np.float32),
                    specular=np.zeros(3, np.float32), shininess=0.0)

    return build_scene_tensors([
        mesh("lights", verts.reshape(-1, 3), np.arange(3 * n_lights, dtype=np.int32)
             .reshape(-1, 3), [4.0, 4.0, 4.0], -1.0),
        mesh("floor", floor, np.array([[0, 2, 1], [0, 3, 2]], np.int32), [0.0, 0.0, 0.0],
             1.0),
    ], device="cpu")


@pytest.mark.parametrize("n_lights, onehot", [(512, True), (513, False)])
def test_light_row_rule_at_512(count_fetches, n_lights, onehot):
    """The light row by the one-hot product up to 512 lights, by the gather
    above (integrator.py:659); the render's value is the same either way,
    and the light table's gradient reaches ke through both."""
    scene = _light_soup(n_lights)
    assert scene.n_lights == n_lights
    ke = scene.ke.clone().requires_grad_()
    s = scene.replace(ke=ke)
    cf, af = make_intersectors(s, "dense")
    ys, xs = torch.meshgrid(torch.arange(8), torch.arange(8), indexing="ij")
    img = render_samples(s, (0.0, 1.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 1.0, 8, 8,
                         xs.reshape(-1), ys.reshape(-1), 0, 1, 0, 2, (0.0, 0.0, 0.0), cf, af)
    img.mean().backward()
    assert (count_fetches["light"] > 0) is onehot
    assert float(img.detach().mean()) > 0 and float(ke.grad.abs().sum()) > 0

    count_fetches["light"] = 0
    table = integrator._light_table(scene)
    li = torch.randint(0, n_lights, (2, 128), generator=torch.Generator().manual_seed(1))
    assert torch.equal(ic.onehot_fetch(table, li), table[:, li])


def test_env_switch_is_read_at_import():
    """CHIAROSCURO_BWD_ONEHOT: 0/false force the gather, 1/true the product,
    anything else (or unset) the size rule; the module reads it once."""
    for value, want in (("0", False), ("false", False), ("FALSE", False), ("1", True),
                        ("true", True), ("", None), ("2", None)):
        assert ic._onehot_setting(value) is want, value
    env = {**os.environ, "CHIAROSCURO_BWD_ONEHOT": "0"}
    out = subprocess.run(
        [sys.executable, "-c", "from chiaroscuro_tpu_torch.ops import intersect_cuda as ic;"
         "print(ic._BWD_ONEHOT)"], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
