"""The beam cull K3b on the CPU: the port's plain sweep
``cull_beam_sweep_plain`` and its lists against the JAX package's
``_rowhit_beam`` and ``_cull_rows_beam`` on the same seeded rays and boxes;
its superset and lower-bound properties against the exact sweep K3; the
beam-culled intersectors against the exact ones; an atrium render with
``beam=True`` against the JAX package's; and the ``CHIAROSCURO_BEAM_CULL``
switch (tests/test_torch_cuda.py holds ``csrc/cull_beam.cu`` to the plain
sweep on a card).

Tolerances: the sweep and the lists are exact (interval endpoints are
subtractions, products, min and max, which XLA has no multiply-add to
contract in); the entries bitwise up to the sign of a zero (the port writes
+0.0 where the JAX package may keep -0.0, as K3 does).  The lower bound
holds to the JAX test's 1e-5 (tests/test_cluster.py:486): the row's bound
is rounded, so it can exceed a lane's rounded entry by an ulp.  The
intersectors' results are exact either way: equal to the exact cull's.
"""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.accel.clusters import build_clusters as jax_build_clusters
from chiaroscuro_tpu.ops.cluster_pallas import _cull_rows_beam as jax_cull_rows_beam
from chiaroscuro_tpu.ops.cluster_pallas import _rowhit_beam as jax_rowhit_beam
from chiaroscuro_tpu.render.renderer import render_image as jax_render_image
from chiaroscuro_tpu.scene.config import RenderConfig as JaxRenderConfig
from chiaroscuro_tpu.scene.scene_arrays import build_scene_arrays
from chiaroscuro_tpu.scene.synthetic import atrium as jax_atrium
from chiaroscuro_tpu_torch.accel.clusters import cluster_arrays_from_numpy
from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
from chiaroscuro_tpu_torch.render.renderer import render_image
from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.obj_loader import Mesh
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    DATA_FIELDS,
    META_FIELDS,
    build_scene_tensors,
    scene_tensors_from_numpy,
)

M = 32
ATRIUM_CAM = ["VP", "1.8", "4.2", "5.0", "LA", "24", "3.2", "6.8",
              "UP", "0", "1", "0", "yview", "0.9"]


def _planar(x):
    return np.ascontiguousarray(x.T.reshape(3, -1, 128))


def _coherent_rows(rng, B0, lo, hi, spread):
    """(o3, d3) f32 (3, B0, 128): each row a bundle around its own origin
    and direction (``spread`` scales the lanes' scatter), as the
    integrator's sorted wavefronts are; row 1's directions are exactly
    axis-parallel on x and y (+-0 components: no definite axis there), and
    row 2's x directions straddle 0."""
    o = rng.uniform(lo, hi, (B0, 1, 3)) + rng.normal(scale=spread, size=(B0, 128, 3))
    d = rng.normal(size=(B0, 1, 3)) + rng.normal(scale=spread, size=(B0, 128, 3))
    d[1, :, :2] = np.where(rng.uniform(size=(128, 2)) < 0.5, 0.0, -0.0)
    d[1, :, 2] = 1.0
    d[2, :, 0] = rng.uniform(-0.2, 0.2, 128)
    o, d = o.astype(np.float32), d.astype(np.float32)
    return (np.ascontiguousarray(o.transpose(2, 0, 1)),
            np.ascontiguousarray(d.transpose(2, 0, 1)))


@pytest.fixture(scope="module")
def atrium_case():
    """atrium(2_200, seed=5) in both packages, the JAX clusters at M = 32,
    6 rows of coherent rays inside the hall and shadow limits."""
    sa = build_scene_arrays(jax_atrium(2_200, seed=5))
    fields = {k: np.asarray(getattr(sa, k)) for k in DATA_FIELDS}
    scene = scene_tensors_from_numpy(fields, {k: getattr(sa, k) for k in META_FIELDS}, "cpu")
    jca = jax_build_clusters(np.asarray(sa.tri_v0), np.asarray(sa.tri_v1),
                             np.asarray(sa.tri_v2), M)
    rng = np.random.default_rng(29)
    lo, hi = scene.world_min.numpy(), scene.world_max.numpy()
    o3, d3 = _coherent_rows(rng, 6, lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), 0.05)
    tmax = rng.uniform(0.5, 12.0, (6, 128)).astype(np.float32)
    return sa, scene, jca, o3, d3, tmax


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


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("with_tmax", [False, True])
def test_plain_beam_sweep_equals_jax(atrium_case, with_tmax):
    """Mask exact, count its row sums, entries bitwise up to a zero's sign
    (and never -0.0 in the port)."""
    _, _, jca, o3, d3, tmax = atrium_case
    tm = tmax if with_tmax else None
    count, key = cc.cull_beam_sweep_plain(_t(o3), _t(d3), _t(jca.bbox_min),
                                          _t(jca.bbox_max), _t(tm))
    hit, entry = (np.asarray(x) for x in jax_rowhit_beam(
        _j(o3), _j(d3), _j(jca.bbox_min), _j(jca.bbox_max), _j(tm)))
    key = key.numpy()
    np.testing.assert_array_equal(key < cc.BIG, hit)
    np.testing.assert_array_equal(count.numpy(), hit.sum(axis=1))
    np.testing.assert_array_equal(key.view(np.int32), (entry + np.float32(0.0)).view(np.int32))
    assert not np.signbit(key).any()
    assert 0.0 < hit.mean() < 1.0 and hit.sum(axis=1).min() < hit.shape[1]


@pytest.mark.parametrize("lmax", [4, 20, 84, cc.DEFAULT_LMAX])
@pytest.mark.parametrize("with_tmax", [False, True])
def test_beam_lists_equal_jax(atrium_case, lmax, with_tmax):
    """meta and ids exact, nears and cutoff bitwise; Lmax = 4 overflows,
    84 leaves one of the K = 85 boxes out, the default takes all."""
    _, _, jca, o3, d3, tmax = atrium_case
    tm = tmax if with_tmax else None
    Le = min(lmax, jca.K)
    got = cc.cull_beam(_t(o3), _t(d3), _t(jca.bbox_min), _t(jca.bbox_max), Le, tmax=_t(tm))
    ref = jax_cull_rows_beam(_j(o3), _j(d3), jca.bbox_min, jca.bbox_max, lmax, tmax=_j(tm))
    for name, a, b in zip(("meta", "ids", "nears", "cutoff"), got, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, name
        if a.dtype == np.float32:
            a, b = a.view(np.int32), (b + np.float32(0.0)).view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)
    plain = cc.cull_beam_plain(_t(o3), _t(d3), _t(jca.bbox_min), _t(jca.bbox_max), Le,
                               tmax=_t(tm))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    if lmax == 4:
        assert got[0][:, 1].all()
    assert Le < jca.K or lmax == cc.DEFAULT_LMAX


# ---------------------------------------------------------------------------
# A torch model of the card's selection (csrc/row_select.cuh), held against
# the stable sort of _order_hits on crafted key matrices.
# ---------------------------------------------------------------------------

BIG_BITS = int(np.float32(cc.BIG).view(np.int32))    # 0x7F61B1E6
BINS = 2048                                          # 11-bit digits: 30..20, 19..9, 8..0


def _find_bin(hist, r):
    """The bin holding rank r of the counts: (bin, counts before it, its own)."""
    cum = torch.cumsum(hist, 0)
    b = int(torch.searchsorted(cum, torch.tensor(r), right=True))
    return b, int(cum[b] - hist[b]), int(hist[b])


def _select_row(bits, r):
    """row_select::select on one row's key bits (K,) int64: the pair of
    rank r as (prefix, shift, below, rank, all, path).  Zero and BIG keys are
    tallied apart from the histograms' other keys and added to their bins,
    as the kernel adds them; path names where the select stopped and after
    how many digits."""
    n_big, n_zero = int((bits == BIG_BITS).sum()), int((bits == 0).sum())
    special = (bits == BIG_BITS) | (bits == 0)
    prefix, shift, below, in_bin, passes = 0, 31, 0, bits.numel(), 0
    while True:
        if prefix == 0 and r < n_zero:
            shift, in_bin, path = 0, n_zero, "zero"
            break
        if prefix == BIG_BITS >> shift and r >= in_bin - n_big:
            below, r = below + in_bin - n_big, r - (in_bin - n_big)
            prefix, shift, in_bin, path = BIG_BITS, 0, n_big, "big"
            break
        if in_bin == r + 1 or shift == 0:
            path = f"{'all' if in_bin == r + 1 else 'ties'} after {passes}"
            break
        nxt = {31: 20, 20: 9, 9: 0}[shift]
        hist = torch.bincount((bits[((bits >> shift) == prefix) & ~special] >> nxt) & (BINS - 1),
                              minlength=BINS)
        if prefix == 0:
            hist[0] += n_zero
        if prefix == BIG_BITS >> shift:
            hist[(BIG_BITS >> nxt) & (BINS - 1)] += n_big
        b, before, in_bin = _find_bin(hist, r)
        prefix, below, r = (prefix << (shift - nxt)) | b, below + before, r - before
        shift, passes = nxt, passes + 1
    return prefix, shift, below, r, in_bin == r + 1, path


def _lists_model(count, key, Le):
    """row_select::write_lists on every row: the pairs below the threshold
    (the whole bin where all its keys are taken) sorted as 64-bit
    (bits << 32) | id, then the threshold's first ties in id order.
    Returns _order_hits's (meta, ids, nears, cutoff) and each row's path."""
    B0, K = key.shape
    bits = key.view(torch.int32).long()
    take = min(Le + 1, K)
    ids = torch.empty((B0, Le), dtype=torch.int32)
    nears = torch.empty((B0, Le), dtype=torch.float32)
    excl = torch.empty((B0,), dtype=torch.int32)
    paths = []
    for b in range(B0):
        prefix, shift, below, rank, all_, path = _select_row(bits[b], take - 1)
        kid = torch.arange(K)
        sel = (bits[b] >> shift) <= prefix if all_ else bits[b] < prefix
        pairs = torch.sort((bits[b][sel] << 32) | kid[sel]).values
        order = pairs & 0xFFFFFFFF
        if not all_:
            assert pairs.numel() == below
            order = torch.cat([order, kid[bits[b] == prefix][:rank + 1]])
        assert order.numel() == take, (b, path)
        ids[b] = order[:Le].to(torch.int32)
        nears[b] = bits[b][order[:Le]].to(torch.int32).view(torch.float32)
        excl[b] = BIG_BITS if K <= Le else int(bits[b][order[Le]])
        paths.append(path)
    over = count > Le
    meta = torch.stack([torch.where(over, Le, count), over.to(torch.int32)], dim=1)
    cutoff = torch.where(over, excl.view(torch.float32), float("inf"))[:, None]
    return (meta, ids, nears, cutoff), paths


def _f32(bits):
    return np.asarray(bits, np.int32).view(np.float32)


def _key_case(name):
    """(count (B0,) int32, key (B0, K) f32, Le) of one crafted case: rows of
    hits (keys below BIG, or equal to it where a hit's entry is BIG) and
    misses (BIG), K and Le small enough to craft the boundary."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    K, Le = 40, 8
    rows = []                                   # (key row, hit count)

    def hits(n, keys=None):
        """A row of n hits at random boxes, the rest misses."""
        row = np.full(K, cc.BIG, np.float32)
        at = rng.choice(K, n, replace=False)
        row[at] = rng.uniform(0.5, 60.0, n).astype(np.float32) if keys is None else keys
        return row, n

    if name == "ties straddle Le":
        for lo, n_tie in ((5, 6), (0, 12), (7, 2), (8, 3)):
            row = np.full(K, cc.BIG, np.float32)
            at = rng.permutation(K)
            row[at[:lo]] = np.sort(rng.uniform(0.5, 2.0, lo)).astype(np.float32)
            row[at[lo:lo + n_tie]] = np.float32(3.25)
            row[at[lo + n_tie:lo + n_tie + 9]] = rng.uniform(4.0, 9.0, 9).astype(np.float32)
            rows.append((row, lo + n_tie + 9))
    elif name == "all BIG":
        rows += [(np.full(K, cc.BIG, np.float32), 0)] * 3
    elif name.startswith("count "):
        n = {"0": 0, "Le-1": Le - 1, "Le": Le, "Le+1": Le + 1, "K": K}[name[6:]]
        rows += [hits(n) for _ in range(4)]
    elif name in ("K == Le", "K == Le + 1"):
        K = Le if name == "K == Le" else Le + 1
        rows += [hits(n) for n in (0, 3, Le - 1, Le, K)]
    elif name == "hit key equal to BIG":
        for n_big_hits in (1, 3, 12):
            row, n = hits(Le - 2)
            free = np.nonzero(row == cc.BIG)[0][:n_big_hits]
            rows.append((row, n + free.size))  # hits whose entry is BIG: keys unchanged
    elif name == "zeros straddle Le":
        for n_zero in (3, Le, Le + 1, 20):
            row, n = hits(30)
            row[np.nonzero(row < cc.BIG)[0][:n_zero]] = 0.0
            rows.append((row, n))
    elif name == "keys share their top digits":
        # Keys one ulp apart share 20 or more top bits: the second and
        # third digits decide, with ties among them.
        base = int(np.float32(7.5).view(np.int32))
        for spread in (8, 600, 5000):
            k = _f32(base + rng.integers(0, spread, 30))
            rows.append(hits(30, k))
    elif name == "denormals and zeros":
        for n_zero in (0, 4, Le, Le + 1):
            k = _f32(rng.integers(1, 1 << 20, 30))
            k[:n_zero] = 0.0
            rows.append(hits(30, k))
    elif name == "keys in BIG's bin":
        lo = BIG_BITS & ~((1 << 20) - 1)
        for n_giant in (2, 9, 20):
            k = np.concatenate([rng.uniform(1.0, 5.0, 30 - n_giant).astype(np.float32),
                                _f32(rng.integers(lo, BIG_BITS, n_giant))])
            row, n = hits(30, k)
            miss = np.nonzero(row == cc.BIG)[0]
            rows.append((row, n + 2))          # and two hits whose entry is BIG
            assert miss.size >= 2
    elif name == "random rows":
        K, Le = 300, 37
        for n in rng.integers(0, K + 1, 12):
            row, _ = hits(int(n), np.round(rng.exponential(5.0, n), 1).astype(np.float32))
            rows.append((row, int(n)))
    else:
        raise KeyError(name)
    key = torch.from_numpy(np.stack([r for r, _ in rows]))
    count = torch.tensor([c for _, c in rows], dtype=torch.int32)
    assert key.shape[1] == K and not torch.signbit(key).any()
    return count, key, Le


KEY_CASES = ["ties straddle Le", "all BIG", "count 0", "count Le-1", "count Le", "count Le+1",
             "count K", "K == Le", "K == Le + 1", "hit key equal to BIG", "zeros straddle Le",
             "keys share their top digits", "denormals and zeros", "keys in BIG's bin",
             "random rows"]


@pytest.mark.parametrize("case", KEY_CASES)
def test_selection_model_equals_stable_sort(case):
    """The kernel's selection (radix threshold, compaction, ties in id order,
    padding with the lowest-numbered BIG keys) gives _order_hits's lists
    bitwise: meta and ids exact, nears and cutoff by their bits."""
    count, key, Le = _key_case(case)
    got, _ = _lists_model(count, key, Le)
    want = cc._order_hits(count, key, Le)
    for field, a, b in zip(("meta", "ids", "nears", "cutoff"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), field


def test_selection_model_takes_every_path():
    """The crafted cases reach every way the select can stop: among the
    zeros, among the BIG keys, with the whole bin taken after each digit,
    and with only some ties of an exact threshold taken."""
    paths = set()
    for case in KEY_CASES:
        count, key, Le = _key_case(case)
        paths.update(_lists_model(count, key, Le)[1])
    assert {"zero", "big", "all after 0", "all after 1", "all after 2", "all after 3",
            "ties after 3"} <= paths, paths


@pytest.mark.parametrize("with_tmax", [False, True])
def test_beam_is_a_superset_with_lower_entries(atrium_case, with_tmax):
    """Every box K3 finds for a row, K3b finds, with an entry no more than
    1e-5 above K3's (the JAX test's bound); the beam finds more."""
    _, _, jca, o3, d3, tmax = atrium_case
    tm = _t(tmax) if with_tmax else None
    bmin, bmax = _t(jca.bbox_min), _t(jca.bbox_max)
    e_count, e_key, e_hit = cc.cull_sweep_plain(_t(o3), _t(d3), bmin, bmax, tm)
    b_count, b_key = cc.cull_beam_sweep_plain(_t(o3), _t(d3), bmin, bmax, tm)
    b_hit = b_key < cc.BIG
    assert bool((b_hit | ~e_hit).all())
    assert bool((b_key[e_hit] <= e_key[e_hit] + 1e-5).all())
    assert bool((b_count >= e_count).all()) and int(b_count.sum()) > int(e_count.sum())


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


@pytest.mark.parametrize("stream", [False, True])
def test_beam_and_exact_intersectors_agree(stream):
    """tests/test_cluster.py:461 on the port: a 300-triangle soup at M = 16
    with 8-wide lists, 256 rays; the beam-culled pair's hits, ids, t, u, v,
    attributes and occlusion equal the exact pair's bitwise."""
    rng = np.random.default_rng(7)
    scene = _soup_scene(rng, 300)
    o = torch.from_numpy(rng.uniform(-4.4, 4.4, (256, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32))
    ca = cc.build_clusters(*(getattr(scene, k).numpy() for k in ("tri_v0", "tri_v1", "tri_v2")),
                           16)
    outs = {}
    for beam in (False, True):
        cf, af = cc.make_cluster_intersectors(scene, M=16, Lmax=8, clusters=ca, stream=stream,
                                              beam=beam)
        assert cf.beam is af.beam is beam
        res = cf(o, d)
        occ = af(o, d, torch.where(res.hit, res.t * 1.1, 1e9), torch.full((256,), -1))
        outs[beam] = (res, occ)
    (a, a_occ), (b, b_occ) = outs[False], outs[True]
    assert 0.2 < float(a.hit.float().mean()) < 1.0
    for f in ("hit", "t", "tid", "u", "v"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for k in a.attrs:
        assert torch.equal(a.attrs[k], b.attrs[k]), k
    assert torch.equal(a_occ, b_occ)


def test_beam_render_matches_jax(atrium_case):
    """atrium(2_200) at M = 32 through the beam-culled cluster pair (the
    plain K3b and visits on the CPU) against the JAX package's render of the
    same scene (its brute oracle), under tests/test_torch_render.py's bound
    (mean |diff| <= 1e-4 x mean radiance, at most 0.5% of pixels outside
    rtol 1e-3), and bitwise equal to the exact-cull render."""
    sa, scene, jca, *_ = atrium_case
    ca = cluster_arrays_from_numpy(dataclasses.asdict(jca))
    tokens = ["input", "synthetic:atrium:2200", "xres", "48", "yres", "27",
              "samples", "2", "k", "3"] + ATRIUM_CAM
    cfg = RenderConfig.from_tokens(tokens + ["platform", "cpu"])
    imgs = {}
    for beam in (False, True):
        pair = cc.make_cluster_intersectors(scene, clusters=ca, beam=beam)
        imgs[beam] = render_image(scene, cfg, intersectors=pair).numpy()
    ref = np.asarray(jax_render_image(
        sa, JaxRenderConfig.from_tokens(tokens + ["intersector", "brute"])))
    img = imgs[True]
    np.testing.assert_array_equal(img.view(np.int32), imgs[False].view(np.int32))
    assert np.isfinite(img).all() and np.median(ref.max(axis=-1)) > 1e-3
    assert float(np.abs(img - ref).mean()) <= 1e-4 * float(ref.mean())
    outside = ~np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    assert outside.mean() <= 0.005


@pytest.mark.parametrize("env, want", [(None, False), ("", False), ("0", False),
                                       ("1", True), ("true", True), ("yes", False)])
def test_beam_none_reads_the_env(monkeypatch, env, want):
    """``beam=None`` reads CHIAROSCURO_BEAM_CULL at each call (``1`` or
    ``true`` turn it on, as cluster_pallas.py:1096); an explicit ``beam``
    overrides it.  Where on, both queries cull with K3b."""
    rng = np.random.default_rng(3)
    scene = _soup_scene(rng, 120)
    if env is None:
        monkeypatch.delenv("CHIAROSCURO_BEAM_CULL", raising=False)
    else:
        monkeypatch.setenv("CHIAROSCURO_BEAM_CULL", env)
    calls = []
    beam_cull = cc.cull_beam
    monkeypatch.setattr(cc, "cull_beam", lambda *a, **k: calls.append(
        k.get("tmax") is not None) or beam_cull(*a, **k))
    cf, af = cc.make_cluster_intersectors(scene, M=16)
    assert cf.beam is af.beam is want
    assert cc.make_cluster_intersectors(scene, M=16, beam=not want)[0].beam is (not want)
    o = torch.from_numpy(rng.uniform(-4.4, 4.4, (128, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(128, 3)).astype(np.float32))
    res = cf(o, d)
    af(o, d, torch.where(res.hit, res.t, 1e9), torch.full((128,), -1))
    assert calls == ([False, True] if want else [])
