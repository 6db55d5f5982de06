"""The CUDA kernels against their plain torch versions, on a
card: K1/K2 (dense), K3 (the cluster cull, also on its edge cases), K4/K5
(the resident cluster visits) and K6/K7 (the streaming ones; on the card
the same two kernels, under their own launch counts), also on rows built so
that a row's warps leave their walks far apart, X1 (the row-hit cull) and
X2 (the double-buffered block fetch); K4/K5 also against K6/K7, the
per-warp visit counts against the torch replay of the exit rule, and the
card's gradients against the CPU's; the Phong extension's renders through
K1/K2, K4/K5 and K6/K7 and its gradients against the CPU's,
``spp_batch`` against one sample a wavefront, B1/B2 (the threaded-BVH
walks) against their plain walk, with a BVH render against the CPU's, and
the tile-sharded frames and gradients of ``parallel/`` on one NCCL rank and
on two gloo ranks sharing the card; K3b (the beam cull) against its plain
version, without a key matrix or a sort, and the beam-culled pair against
the exact one, and the one-hot
backward's gradients run to run and under TF32 precision settings, and the
gather's backward (the sort-by-id segmented row sum) against its plain
version, run to run, on wrong inputs and through the cluster path's
gradients.

Card-only (marker ``cuda``): without a CUDA device every test skips inside
the fixture.  This file imports no jax, so it also runs on a machine
without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

On the card the kernels must equal their plain versions bitwise: they are
built with ``-fmad=false`` and keep the plain version's operand order; the
cull has no multiply-add to contract, and its sign-chosen planes change no
rounding (tests/test_torch_cull.py).
"""

import numpy as np
import pytest
import torch

from chiaroscuro_tpu_torch.accel.clusters import build_clusters
from chiaroscuro_tpu_torch.accel.dispatch import make_intersectors, resolve_auto
from chiaroscuro_tpu_torch.ops import cluster_cuda as cc
from chiaroscuro_tpu_torch.ops import intersect_cuda as ic
from chiaroscuro_tpu_torch.scene.builtin import cornell_box
from chiaroscuro_tpu_torch.scene.scene_arrays import build_scene_tensors
from chiaroscuro_tpu_torch.scene.synthetic import atrium
from chiaroscuro_tpu_torch.tools import cull_experiments as xc
from chiaroscuro_tpu_torch.tools import dma_min as dm

B0 = 37   # rows of 128 rays; row 1 and every third row after it dead


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _soup_tris(rng, n, dev):
    v0 = rng.uniform(0, 1, (n, 3))
    v = [v0, v0 + rng.normal(scale=0.1, size=(n, 3)), v0 + rng.normal(scale=0.1, size=(n, 3))]
    return [torch.tensor(x, dtype=torch.float32, device=dev) for x in v]


# K1/K2 cases.  "soup<T>": T random triangles (0, 1, 36, the resident 4,096,
# and past it 4,097 and 9,000, where the kernels sweep the table in chunks);
# "ties": 500 triangles twice over, ids i and i + 500 tying exactly;
# "rows1"/"rows7"/"round": B0 of 1, 7 and one more than a round of the
# persistent grid's warps; "dead": every row dead; "blocked": a first
# triangle in front of every ray.
DENSE_CASES = ["cornell", "soup1000", "soup0", "soup1", "soup36", "soup4096", "soup4097",
               "soup9000", "ties", "rows1", "rows7", "round", "dead", "blocked"]


def _tables(name, dev):
    rng = np.random.default_rng(9)
    nB0 = B0
    if name == "cornell":
        s = build_scene_tensors(cornell_box(), device=dev)
        v = (s.tri_v0, s.tri_v1, s.tri_v2)
        attrs = ic._prep_attrs(s)
    else:
        n = int(name[4:]) if name.startswith("soup") else 1000
        v = _soup_tris(rng, n if name != "ties" else 500, dev)
        if name == "ties":
            v = [torch.cat([x, x]) for x in v]
        if name == "blocked":
            # Triangle 0 spans z = 2 far past the unit cube, facing rays
            # that leave z = -1 along +z.
            big = [torch.tensor([[-50.0, -50.0, 2.0]], device=dev),
                   torch.tensor([[150.0, -50.0, 2.0]], device=dev),
                   torch.tensor([[-50.0, 150.0, 2.0]], device=dev)]
            v = [torch.cat([b, x[1:]]) for b, x in zip(big, v)]
        attrs = torch.tensor(rng.normal(size=(v[0].shape[0], ic.ATTR_K)), dtype=torch.float32,
                             device=dev)
        if name in ("rows1", "rows7"):
            nB0 = int(name[4:])
        elif name == "round":
            # One more than a multiple of the rows every resident warp of a
            # one-block- or two-block-an-SM grid takes in one pass (32 warps
            # a block, 4 warps a row).
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            nB0 = 2 * sms * 8 + 1
    rows = ic._prep_tris(*v)
    T = rows.shape[0]
    pts = torch.cat(v).cpu().numpy() if T else np.zeros((1, 3))
    lo, hi = pts.min(0), pts.max(0) + (0.0 if T else 1.0)
    ext = (hi - lo)[:, None, None]
    o = rng.uniform(lo[:, None, None] - 0.1 * ext, hi[:, None, None] + 0.1 * ext, (3, nB0, 128))
    d = rng.normal(size=(3, nB0, 128))
    tmax = rng.uniform(0, 1.5 * float(ext.max()), (nB0, 128))
    excl = rng.integers(0, max(T, 1), (nB0, 128))
    if name == "blocked":
        o[:2] = rng.uniform(0, 1, (2, nB0, 128))
        o[2] = -1.0
        d[2] = np.abs(d[2]) + 1.0
        tmax[:] = 1e6
        excl[:] = -1
    q = dict(o3=o, d3=d, tmax=tmax)
    q = {k: torch.tensor(x, dtype=torch.float32, device=dev) for k, x in q.items()}
    q["excl"] = torch.tensor(excl, dtype=torch.int32, device=dev)
    live = torch.ones(nB0, dtype=torch.int32, device=dev)
    live[1::3] = 0
    if name == "dead":
        live[:] = 0
    q["live"] = live
    return rows, attrs, q


@pytest.mark.cuda
@pytest.mark.parametrize("name", DENSE_CASES)
def test_kernels_equal_plain_on_card(name, cuda_device):
    """K1/K2 bitwise equal to their plain versions, one launch each, with
    the table the wrappers make and with one made beforehand."""
    rows, attrs, q = _tables(name, cuda_device)
    before = dict(ic.LAUNCHES)
    got = ic.closest_dense(q["live"], q["o3"], q["d3"], rows, attrs)
    occ = ic.any_dense(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == {"closest": before["closest"] + 1, "any": before["any"] + 1}
    want = ic.closest_dense_plain(q["live"], q["o3"], q["d3"], rows, attrs)
    for field, a, b in zip(("t", "id", "u", "v", "attrs"), got, want):
        assert torch.equal(_bits(a), _bits(b)), field
    assert torch.equal(
        occ, ic.any_dense_plain(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows)
    )
    table = ic.pad_table(rows)
    again = ic.closest_dense(q["live"], q["o3"], q["d3"], rows, attrs, table)
    for a, b in zip(again, got):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(ic.any_dense(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows,
                                    table), occ)
    hit = got[0] < ic.BIG
    live = q["live"].bool()
    assert not bool(hit[~live].any()) and not bool(occ[~live].any())
    if name in ("cornell", "soup1000", "soup4096", "soup4097", "soup9000", "ties", "round"):
        assert 0.05 < float(hit[live].float().mean()) < 0.95
        assert 0.05 < float(occ[live].float().mean()) < 0.95
    if name in ("soup0", "dead"):
        assert not bool(hit.any()) and not bool(occ.any())
    if name == "ties":
        assert bool((got[1][hit] < rows.shape[0] // 2).all())
    if name == "blocked":
        assert bool(occ[live].all())


@pytest.mark.cuda
def test_kernels_on_concurrent_streams(cuda_device):
    """K1/K2 launched in turns on two streams, each stream's launches
    queued behind the other's, stay bitwise equal to their plain versions:
    each stream has its own work counters."""
    inputs = [_tables(name, cuda_device) for name in ("soup4096", "cornell")]
    want = [(ic.closest_dense_plain(q["live"], q["o3"], q["d3"], rows, attrs),
             ic.any_dense_plain(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows))
            for rows, attrs, q in inputs]
    tables = [ic.pad_table(rows) for rows, _, _ in inputs]
    streams = [torch.cuda.Stream(cuda_device) for _ in inputs]
    torch.cuda.synchronize()
    got = [[] for _ in inputs]
    for _ in range(3):
        for k, ((rows, attrs, q), table, stream) in enumerate(zip(inputs, tables, streams)):
            with torch.cuda.stream(stream):
                got[k].append((
                    ic.closest_dense(q["live"], q["o3"], q["d3"], rows, attrs, table),
                    ic.any_dense(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows,
                                 table)))
    torch.cuda.synchronize()
    for k, (closest, occ) in enumerate(want):
        for hit, blocked in got[k]:
            for a, b in zip(hit, closest):
                assert torch.equal(_bits(a), _bits(b))
            assert torch.equal(blocked, occ)


@pytest.mark.cuda
def test_kernel_launch_errors_raise(cuda_device):
    """A CUDA tensor never falls back to the plain version: a bad input
    raises before launch."""
    rows, attrs, q = _tables("cornell", cuda_device)
    with pytest.raises(ValueError, match="on cpu"):
        ic.closest_dense(q["live"], q["o3"], q["d3"].cpu(), rows, attrs)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("lmax", [6, 1536])
def test_cluster_kernels_equal_plain_on_card(lmax, cuda_device):
    """K3 exact, K6/K7 bitwise on atrium(2_200, seed=5) at M = 32 (K = 85);
    Lmax = 6 overflows rows into the phase-2 sweep."""
    scene = build_scene_tensors(atrium(2_200, seed=5), device=cuda_device)
    ca = build_clusters(*(x.cpu().numpy() for x in (scene.tri_v0, scene.tri_v1, scene.tri_v2)), 32)
    packed, attrs = cc.derive_buffers(scene, ca)
    bmin = torch.from_numpy(ca.bbox_min).to(cuda_device)
    bmax = torch.from_numpy(ca.bbox_max).to(cuda_device)
    rng = np.random.default_rng(5)
    lo, hi = scene.world_min.cpu().numpy(), scene.world_max.cpu().numpy()
    o3 = rng.uniform(lo[:, None, None], hi[:, None, None], (3, B0, 128))
    q = dict(o3=o3, d3=rng.normal(size=(3, B0, 128)), tmax=rng.uniform(0.1, 15.0, (B0, 128)))
    q = {k: torch.tensor(x, dtype=torch.float32, device=cuda_device) for k, x in q.items()}
    excl = torch.tensor(rng.integers(-1, scene.n_tris, (B0, 128)), dtype=torch.int32,
                        device=cuda_device)
    Le = min(lmax, ca.K)
    before = dict(cc.LAUNCHES)
    lists = cc.cull(q["o3"], q["d3"], bmin, bmax, Le)
    slists = cc.cull(q["o3"], q["d3"], bmin, bmax, Le, tmax=q["tmax"])
    got = cc.closest_cluster(*lists, q["o3"], q["d3"], packed, attrs)
    occ = cc.any_cluster(*slists, q["o3"], q["d3"], q["tmax"], excl, packed)
    torch.cuda.synchronize()
    assert {k: cc.LAUNCHES[k] - before[k] for k in before} == {
        "cull": 2, "cull_beam": 0, "closest_resident": 0, "any_resident": 0,
        "closest_cluster": 1, "any_cluster": 1}
    for a, b in zip(lists, cc.cull_plain(q["o3"], q["d3"], bmin, bmax, Le)):
        assert torch.equal(a, b)
    for a, b in zip(slists, cc.cull_plain(q["o3"], q["d3"], bmin, bmax, Le, tmax=q["tmax"])):
        assert torch.equal(a, b)
    assert bool(lists[0][:, 1].any()) == (lmax == 6)
    want = cc.closest_cluster_plain(*lists, q["o3"], q["d3"], packed, attrs)
    for field, a, b in zip(("t", "id", "u", "v", "attrs"), got, want):
        assert torch.equal(_bits(a), _bits(b)), field
    assert torch.equal(occ, cc.any_cluster_plain(*slists, q["o3"], q["d3"], q["tmax"], excl, packed))
    assert 0.5 < float((got[0] < cc.BIG).float().mean())
    assert 0.05 < float(occ.float().mean()) < 0.95


@pytest.mark.cuda
def test_dispatch_resolves_cluster_on_card(cuda_device):
    """Above 4,096 triangles ``auto`` takes the cluster path on a card; a
    scene whose packed matrix fits the residency budget runs the resident
    K4/K5, and ``stream=True`` forces K6/K7."""
    scene = build_scene_tensors(atrium(6_000), device=cuda_device)
    assert scene.n_tris > 4096 and resolve_auto(scene.n_tris, on_gpu=True) == "cluster"
    cf, af = make_intersectors(scene, "auto")
    assert cf.route == af.route == "resident"
    cf, af = cc.make_cluster_intersectors(scene, stream=True)
    assert cf.route == "stream" and not cf.prefers_compaction


def _atrium_lists(dev, lmax, m=32):
    """atrium(2_200, seed=5) at M = m with seeded rays and both lists."""
    scene = build_scene_tensors(atrium(2_200, seed=5), device=dev)
    ca = build_clusters(*(x.cpu().numpy() for x in (scene.tri_v0, scene.tri_v1, scene.tri_v2)), m)
    packed, attrs = cc.derive_buffers(scene, ca)
    bmin = torch.from_numpy(ca.bbox_min).to(dev)
    bmax = torch.from_numpy(ca.bbox_max).to(dev)
    rng = np.random.default_rng(6)
    lo, hi = scene.world_min.cpu().numpy(), scene.world_max.cpu().numpy()
    o3 = rng.uniform(lo[:, None, None], hi[:, None, None], (3, B0, 128))
    q = dict(o3=o3, d3=rng.normal(size=(3, B0, 128)), tmax=rng.uniform(0.1, 15.0, (B0, 128)))
    q = {k: torch.tensor(x, dtype=torch.float32, device=dev) for k, x in q.items()}
    q["excl"] = torch.tensor(rng.integers(-1, scene.n_tris, (B0, 128)), dtype=torch.int32,
                             device=dev)
    Le = min(lmax, ca.K)
    q["boxes"] = (bmin, bmax)
    q["lists"] = cc.cull(q["o3"], q["d3"], bmin, bmax, Le)
    q["slists"] = cc.cull(q["o3"], q["d3"], bmin, bmax, Le, tmax=q["tmax"])
    return packed, attrs, q


# (M, Lmax): M = 32 (K = 85) overflowing into phase 2 and not; the main
# path's M = 128 (K = 22); M = 1024 (K = 3), where K4's ring holds one slot
# a warp (two need 320 KB).
RESIDENT_CASES = [(32, 6), (32, 1536), (128, 6), (1024, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("m, lmax", RESIDENT_CASES)
def test_resident_kernels_equal_streaming_and_plain(m, lmax, cuda_device):
    """K4 bitwise equal to K6 and K5 to K7 on the same lists (on the card
    one kernel each, launched under two names), and both to the plain
    versions.  Every
    kernel's visit counts are per warp and equal the torch replay of the
    exit rule exactly; a warp visits no more clusters than a row walking
    together would."""
    packed, attrs, q = _atrium_lists(cuda_device, lmax, m)
    o3, d3, lists, slists = q["o3"], q["d3"], q["lists"], q["slists"]
    tmax, excl = q["tmax"], q["excl"]
    v6, v7 = (torch.zeros((B0, cc.WARPS), dtype=torch.int32, device=cuda_device)
              for _ in range(2))
    k6 = cc.closest_cluster(*lists, o3, d3, packed, attrs, visits=v6)
    k7 = cc.any_cluster(*slists, o3, d3, tmax, excl, packed, visits=v7)
    want = cc.closest_cluster_plain(*lists, o3, d3, packed, attrs)
    want_occ = cc.any_cluster_plain(*slists, o3, d3, tmax, excl, packed)
    w4 = cc.visit_counts_plain(*lists, o3, d3, packed)
    w5 = cc.visit_counts_plain(*slists, o3, d3, packed, tmax, excl)
    torch.cuda.synchronize()
    assert torch.equal(v6, w4) and torch.equal(v7, w5)
    row6 = cc.visit_counts_plain(*lists, o3, d3, packed, lanes=128)[:, 0]
    row7 = cc.visit_counts_plain(*slists, o3, d3, packed, tmax, excl, lanes=128)[:, 0]
    assert bool(lists[0][:, 1].any()) == (lmax == 6 and packed.shape[0] > 6)
    v4, v5 = (torch.zeros((B0, cc.WARPS), dtype=torch.int32, device=cuda_device)
              for _ in range(2))
    before = dict(cc.LAUNCHES)
    k4 = cc.closest_resident(*lists, o3, d3, packed, attrs, visits=v4)
    k5 = cc.any_resident(*slists, o3, d3, tmax, excl, packed, visits=v5)
    torch.cuda.synchronize()
    assert {k: cc.LAUNCHES[k] - before[k] for k in before} == {
        "cull": 0, "cull_beam": 0, "closest_resident": 1, "any_resident": 1,
        "closest_cluster": 0, "any_cluster": 0}
    for field, a, b, c in zip(("t", "id", "u", "v", "attrs"), k4, k6, want):
        assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a), _bits(c)), field
    assert torch.equal(k5, k7) and torch.equal(k5, want_occ)
    assert torch.equal(v4, w4) and torch.equal(v5, w5)
    for got, row in ((v4, row6), (v5, row7)):
        assert bool((got <= row[:, None]).all()) and bool((got.amax(1) == row).all())
    assert int(v4.sum()) > 0 and int(v5.sum()) > 0
    assert 0.05 < float(want_occ.float().mean()) < 0.95


def _built_rows(dev, lmax, m):
    """:func:`_atrium_lists` with rows built for the per-warp walks: row 0
    parked (every lane outside the scene, pointing away: trip 0); in rows
    2, 5, 8, ... warp 0 keeps its rays inside the scene (near hits) with
    tmax -1 (below every near: its occlusion walk needs no visit), while warp 2's lanes start
    outside the scene pointing away (they hit nothing, so their closest
    walk and, with tmax huge, their occlusion walk take the whole list)."""
    packed, attrs, q = _atrium_lists(dev, lmax, m)
    scene_max = q["o3"].amax(dim=(1, 2))
    o3, d3, tmax = q["o3"].clone(), q["d3"].clone(), q["tmax"].clone()
    away = scene_max[:, None] + 50.0
    o3[:, 0], d3[:, 0] = away, 1.0
    rows = torch.arange(2, B0, 3, device=dev)
    o3[:, rows, 64:96] = away[:, :, None]
    d3[:, rows, 64:96] = 1.0
    tmax[rows, 0:32] = -1.0
    tmax[rows, 64:96] = 1.0e30
    bmin, bmax = q["boxes"]
    Le = q["lists"][1].shape[1]
    q.update(o3=o3, d3=d3, tmax=tmax, lists=cc.cull(o3, d3, bmin, bmax, Le),
             slists=cc.cull(o3, d3, bmin, bmax, Le, tmax=tmax))
    return packed, attrs, q, rows


# (M, Lmax) for the built rows: M = 32 (K = 85) with lists far longer than
# a warp's ring of two slots, overflowing into phase 2 and not; M = 128
# (K = 22); M = 1024 (K = 3), one slot a warp, opted in.
BUILT_CASES = [(32, 6), (32, 1536), (128, 1536), (1024, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("m, lmax", BUILT_CASES)
def test_visit_walks_on_built_rows_on_card(m, lmax, cuda_device):
    """K4-K7 on rows built so that a row's warps leave the walk far apart
    (one warp needs the whole list, another none), trip-0 rows, overflow
    rows and lists longer than a warp's ring: K6/K7 bitwise equal to the
    plain versions and to K4/K5, every kernel's per-warp visit counts
    equal to the replay, each launch counted under its own name."""
    packed, attrs, q, rows = _built_rows(cuda_device, lmax, m)
    o3, d3, lists, slists = q["o3"], q["d3"], q["lists"], q["slists"]
    tmax, excl = q["tmax"], q["excl"]
    counts = {k: torch.zeros((B0, cc.WARPS), dtype=torch.int32, device=cuda_device)
              for k in ("k4", "k5", "k6", "k7")}
    before = dict(cc.LAUNCHES)
    k6 = cc.closest_cluster(*lists, o3, d3, packed, attrs, visits=counts["k6"])
    k7 = cc.any_cluster(*slists, o3, d3, tmax, excl, packed, visits=counts["k7"])
    k4 = cc.closest_resident(*lists, o3, d3, packed, attrs, visits=counts["k4"])
    k5 = cc.any_resident(*slists, o3, d3, tmax, excl, packed, visits=counts["k5"])
    torch.cuda.synchronize()
    assert {k: cc.LAUNCHES[k] - before[k] for k in before} == {
        "cull": 0, "cull_beam": 0, "closest_resident": 1, "any_resident": 1,
        "closest_cluster": 1, "any_cluster": 1}
    want = cc.closest_cluster_plain(*lists, o3, d3, packed, attrs)
    for field, a, b, c in zip(("t", "id", "u", "v", "attrs"), k6, k4, want):
        assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a), _bits(c)), field
    assert torch.equal(k7, k5)
    assert torch.equal(k7, cc.any_cluster_plain(*slists, o3, d3, tmax, excl, packed))
    w_closest = cc.visit_counts_plain(*lists, o3, d3, packed)
    w_any = cc.visit_counts_plain(*slists, o3, d3, packed, tmax, excl)
    for k, w in (("k4", w_closest), ("k6", w_closest), ("k5", w_any), ("k7", w_any)):
        assert torch.equal(counts[k], w), k
    trip, strip = lists[0][:, 0], slists[0][:, 0]
    # The parked row visits nothing; in the built rows warp 2 walks the
    # whole list while warp 0 needs no occlusion visit.
    assert int(trip[0]) == 0 and int(strip[0]) == 0
    assert not bool(counts["k6"][0].any()) and not bool(counts["k7"][0].any())
    full = ~lists[0][rows, 1].bool()
    assert torch.equal(counts["k6"][rows, 2][full], trip[rows][full])
    assert not bool(counts["k7"][rows, 0].any())
    sfull = ~slists[0][rows, 1].bool()
    assert bool((counts["k7"][rows, 2][sfull] == strip[rows][sfull]).all())
    assert bool(((counts["k7"][rows, 2] > 0) & (counts["k7"][rows, 0] == 0)).any())
    if m == 32:
        assert int(trip.max()) > 4                          # lists past the ring
    assert bool(lists[0][:, 1].any()) == (lmax == 6 and packed.shape[0] > 6)
    assert bool((~k7[rows, 64:96]).all())                   # warp 2 never occluded


def _cull_inputs(dev, B0_, K, with_tmax, axis_parallel, on_planes, seed):
    """Seeded boxes in the unit cube (the first three nested around the
    centre) and B0_ rows of rays: with ``axis_parallel`` a share of +-0
    direction components; with ``on_planes`` every third lane starts on a
    box's entry plane (near = -0.0 on a hi side) and row 0 at the centre,
    inside several boxes."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.0, 0.9, (K, 3))
    hi = lo + rng.uniform(0.02, 0.3, (K, 3))
    for k, s in enumerate((0.1, 0.2, 0.4)[:K]):
        lo[k], hi[k] = 0.5 - s, 0.5 + s
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    n = B0_ * 128
    o = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if axis_parallel:
        zero = rng.uniform(size=(n, 3)) < 0.3
        d[zero] = np.where(rng.uniform(size=zero.sum()) < 0.5, 0.0, -0.0)
    if on_planes:
        for i in range(0, n, 3):
            k, a = rng.integers(K), rng.integers(3)
            o[i] = lo[k] + (hi[k] - lo[k]) * rng.uniform(0.1, 0.9, 3).astype(np.float32)
            hi_side = rng.uniform() < 0.5
            o[i, a] = hi[k, a] if hi_side else lo[k, a]
            d[i, a] = -abs(d[i, a]) - 0.1 if hi_side else abs(d[i, a]) + 0.1
        o[:128] = 0.5
    planar = lambda x: np.ascontiguousarray(x.T.reshape(3, B0_, 128))
    t = {"o3": planar(o), "d3": planar(d), "bmin": lo, "bmax": hi,
         "tmax": rng.uniform(0.0, 1.0, (B0_, 128)).astype(np.float32) if with_tmax else None}
    return {k: None if v is None else torch.from_numpy(v).to(dev) for k, v in t.items()}


CULL_CASES = {
    # name: (B0, K, tmax, axis-parallel lanes, origins on planes)
    "one row": (1, 150, False, False, False),
    "one box": (3, 1, False, True, False),
    "K not a multiple of the chunk": (5, 150, False, False, False),
    "K not a multiple of the chunk, tmax": (5, 150, True, False, False),
    "axis-parallel directions": (4, 64, False, True, False),
    "origins on box planes": (4, 130, False, False, True),
    "origins on box planes, tmax": (4, 130, True, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CULL_CASES))
def test_k3_equals_plain_on_card(case, cuda_device):
    """K3 (``csrc/cull_rows.cu``) against its plain sweep on the same card
    tensors: hit mask and count exact, keys bitwise (+0.0 entries); with
    and without the hit output; the lists of ``cull`` exact (nears and
    cutoff bitwise) at a width that overflows and one that does not."""
    B0_, K, with_tmax, axis_parallel, on_planes = CULL_CASES[case]
    t = _cull_inputs(cuda_device, B0_, K, with_tmax, axis_parallel, on_planes,
                     seed=list(CULL_CASES).index(case))
    args = (t["o3"], t["d3"], t["bmin"], t["bmax"], t["tmax"])
    before = cc.LAUNCHES["cull"]
    count, key, hit = cc.cull_sweep(*args, hits=True)
    count2, key2, none = cc.cull_sweep(*args)
    torch.cuda.synchronize()
    assert cc.LAUNCHES["cull"] == before + 2 and none is None
    p_count, p_key, p_hit = cc.cull_sweep_plain(*args)
    assert torch.equal(hit, p_hit) and torch.equal(count, p_count) and torch.equal(count2, count)
    assert torch.equal(_bits(key), _bits(p_key)) and torch.equal(_bits(key2), _bits(key))
    assert not bool(torch.signbit(key).any())
    if on_planes:
        assert bool((hit & (key == 0.0)).any())
    for le in {1, min(4, K), K}:
        got = cc.cull(t["o3"], t["d3"], t["bmin"], t["bmax"], le, tmax=t["tmax"])
        want = cc.cull_plain(t["o3"], t["d3"], t["bmin"], t["bmax"], le, tmax=t["tmax"])
        for field, a, b in zip(("meta", "ids", "nears", "cutoff"), got, want):
            assert torch.equal(_bits(a), _bits(b)), (le, field)


@pytest.mark.cuda
def test_k3_with_no_boxes_on_card(cuda_device):
    """K = 0: no launch, and every count zero (not whatever the allocator
    hands back: a freed block of the count's size filled with 7s is there
    to be reused), keys and hit mask without a column."""
    t = _cull_inputs(cuda_device, 5, 3, False, False, False, seed=4)
    junk = torch.full((5,), 7, dtype=torch.int32, device=cuda_device)
    del junk
    before = cc.LAUNCHES["cull"]
    for tmax in (None, torch.ones((5, 128), device=cuda_device)):
        count, key, hit = cc.cull_sweep(t["o3"], t["d3"], t["bmin"][:0], t["bmax"][:0], tmax,
                                        hits=True)
        torch.cuda.synchronize()
        assert torch.equal(count, torch.zeros(5, dtype=torch.int32, device=cuda_device))
        assert key.shape == hit.shape == (5, 0)
    assert cc.LAUNCHES["cull"] == before


@pytest.mark.cuda
def test_k3_checks_alignment_on_card(cuda_device):
    """A CUDA tensor never falls back to the plain sweep: boxes that are
    not 16-byte aligned raise before launch."""
    t = _cull_inputs(cuda_device, 2, 10, False, False, False, seed=3)
    shifted = torch.empty(31, device=cuda_device)[1:].view(10, 3)
    shifted.copy_(t["bmin"])
    with pytest.raises(ValueError, match="16-byte aligned"):
        cc.cull_sweep(t["o3"], t["d3"], shifted, t["bmax"])


def _beam_inputs(dev, B0_, K, with_tmax, seed, twins=False):
    """Seeded boxes in the unit cube and B0_ rows of coherent rays (each row
    a bundle around its own origin and direction, as the integrator's
    sorted wavefronts are): row 0's x and y directions are +-0 (no definite
    axis there), row 1's x directions straddle 0, one lane of row 2 has a
    denormal x direction (1/D is infinite there: NaN products must miss),
    row 3 starts inside the boxes' span (entries of +0.0).  With ``twins``
    the second half of the boxes repeats the first (equal keys: ties at
    every list width)."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.0, 0.9, (K, 3))
    hi = lo + rng.uniform(0.02, 0.3, (K, 3))
    if twins:
        lo[K // 2:2 * (K // 2)], hi[K // 2:2 * (K // 2)] = lo[:K // 2], hi[:K // 2]
    o = rng.uniform(-0.5, 1.5, (B0_, 1, 3)) + rng.normal(scale=0.02, size=(B0_, 128, 3))
    d = rng.normal(size=(B0_, 1, 3)) + rng.normal(scale=0.05, size=(B0_, 128, 3))
    d[0, :, :2] = np.where(rng.uniform(size=(128, 2)) < 0.5, 0.0, -0.0)
    if B0_ > 1:
        d[1, :, 0] = rng.uniform(-0.1, 0.1, 128)
    if B0_ > 2:
        d[2, :, 0] = np.abs(d[2, :, 0]) + 0.1
        d[2, 5, 0] = 1e-40
    if B0_ > 3:
        o[3] = 0.5
    planar = lambda x: np.ascontiguousarray(x.astype(np.float32).transpose(2, 0, 1))
    t = {"o3": planar(o), "d3": planar(d), "bmin": lo.astype(np.float32),
         "bmax": hi.astype(np.float32),
         "tmax": rng.uniform(0.0, 1.0, (B0_, 128)).astype(np.float32) if with_tmax else None}
    return {k: None if v is None else torch.from_numpy(v).to(dev) for k, v in t.items()}


def _beam_lists_equal(t, le):
    """One ``cull_beam`` launch against ``cull_beam_plain`` on the same card
    tensors: meta and ids exact, nears and cutoff bitwise.  Returns the
    kernel's lists."""
    before = cc.LAUNCHES["cull_beam"]
    got = cc.cull_beam(t["o3"], t["d3"], t["bmin"], t["bmax"], le, tmax=t["tmax"])
    torch.cuda.synchronize()
    assert cc.LAUNCHES["cull_beam"] == before + 1
    want = cc.cull_beam_plain(t["o3"], t["d3"], t["bmin"], t["bmax"], le, tmax=t["tmax"])
    for field, a, b in zip(("meta", "ids", "nears", "cutoff"), got, want):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), (le, field)
    return got


BEAM_CASES = {
    # name: (B0, K, tmax): one row, rows past one wave, K past a warp's and
    # a block's share of the boxes
    "one row, one box": (1, 1, False),
    "rows 13, K 150": (13, 150, False),
    "rows 13, K 150, tmax": (13, 150, True),
    "rows 9, K 2,500": (9, 2500, False),
    "rows 9, K 2,500, tmax": (9, 2500, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_k3b_equals_plain_on_card(case, cuda_device):
    """K3b (``csrc/cull_beam.cu``) against its plain version on the same
    card tensors at widths 1, 4, K - 1 and K, one launch each: meta and
    ids exact, nears and cutoff bitwise.  At Le = K the lists hold every
    key in order, so every key equals the plain sweep's bitwise (+0.0
    entries, never -0.0), and every box K3 hits has a key below BIG."""
    B0_, K, with_tmax = BEAM_CASES[case]
    t = _beam_inputs(cuda_device, B0_, K, with_tmax, seed=list(BEAM_CASES).index(case))
    for le in sorted({1, min(4, K), max(K - 1, 1), K}):
        meta, ids, nears, _ = _beam_lists_equal(t, le)
    args = (t["o3"], t["d3"], t["bmin"], t["bmax"], t["tmax"])
    count, key = cc.cull_beam_sweep_plain(*args)
    assert torch.equal(meta[:, 0], count) and not bool(torch.signbit(nears).any())
    full = torch.empty_like(key).scatter_(1, ids.long(), nears)
    assert torch.equal(_bits(full), _bits(key))
    assert bool((count < K).any()) or K == 1
    exact_hit = cc.cull_sweep_plain(*args)[2]
    assert bool(((full < cc.BIG) | ~exact_hit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("with_tmax", [False, True])
@pytest.mark.parametrize("le", [cc.DEFAULT_LMAX, 9])
def test_k3b_lists_at_the_default_and_a_small_width_on_card(le, with_tmax, cuda_device):
    """K = 4,000 boxes whose second half repeats the first, 40 rows: at the
    default Le = 1,536 (short rows padded with BIG keys) and at Le = 9 (most
    rows overflow; a twin's key ends the list and repeats past it) the lists
    equal the plain version's bitwise."""
    t = _beam_inputs(cuda_device, 40, 4000, with_tmax, seed=11, twins=True)
    meta, _, nears, _ = _beam_lists_equal(t, le)
    over = meta[:, 1].bool()
    assert bool(over.any()) and (le == cc.DEFAULT_LMAX or int(over.sum()) > 10)
    # Some row's list ends on a key that the next pair repeats.
    _, p_key = cc.cull_beam_sweep_plain(t["o3"], t["d3"], t["bmin"], t["bmax"], t["tmax"])
    skey = torch.sort(p_key, dim=1).values
    assert bool((skey[:, le - 1] == skey[:, le]).any())


@pytest.mark.cuda
def test_k3b_allocates_no_key_matrix_and_sorts_nothing_on_card(monkeypatch, cuda_device):
    """On the card ``cull_beam`` never reaches a torch sort (each raises
    here), and the device memory it allocates at its peak is its four
    outputs: no (B0, K) tensor (B0 = 64, K = 20,000: 5.1 MB of keys)."""
    t = _beam_inputs(cuda_device, 64, 20_000, True, seed=12)
    le = cc.DEFAULT_LMAX
    cc.cull_beam(t["o3"], t["d3"], t["bmin"], t["bmax"], le, tmax=t["tmax"])  # the build

    def refuse(*a, **k):
        raise AssertionError("K3b reached a torch sort on the card")

    for name in ("sort", "argsort", "topk", "msort"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse, raising=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    held = torch.cuda.memory_allocated(cuda_device)
    before = cc.LAUNCHES["cull_beam"]
    out = cc.cull_beam(t["o3"], t["d3"], t["bmin"], t["bmax"], le, tmax=t["tmax"])
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(cuda_device) - held
    out_bytes = sum(-(-x.numel() * x.element_size() // 512) * 512 for x in out)
    assert cc.LAUNCHES["cull_beam"] == before + 1
    assert grew <= out_bytes < 64 * 20_000 * 4, (grew, out_bytes)
    monkeypatch.undo()
    want = cc.cull_beam_plain(t["o3"], t["d3"], t["bmin"], t["bmax"], le, tmax=t["tmax"])
    for a, b in zip(out, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_k3b_with_no_boxes_on_card(cuda_device):
    """K = 0: no list width fits (Le must lie in [1, K]), so ``cull_beam``
    raises before any launch, as it does on the CPU; the plain sweep counts
    no hit and has no key column."""
    t = _beam_inputs(cuda_device, 5, 3, False, seed=4)
    before = cc.LAUNCHES["cull_beam"]
    for tmax in (None, torch.ones((5, 128), device=cuda_device)):
        with pytest.raises(ValueError, match="list width"):
            cc.cull_beam(t["o3"], t["d3"], t["bmin"][:0], t["bmax"][:0], 1, tmax=tmax)
        count, key = cc.cull_beam_sweep_plain(t["o3"], t["d3"], t["bmin"][:0],
                                              t["bmax"][:0], tmax)
        assert torch.equal(count, torch.zeros(5, dtype=torch.int32, device=cuda_device))
        assert key.shape == (5, 0)
    assert cc.LAUNCHES["cull_beam"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("K, le", [(60_000, 1536), (30_000, 29_999)])
def test_k3b_raises_where_a_row_outgrows_shared_memory_on_card(K, le, cuda_device):
    """A row's K keys (60,000 boxes) or its list (Le + 1 = 30,000 pairs)
    past a block's shared memory: ValueError before any launch, no
    fallback."""
    t = _beam_inputs(cuda_device, 2, K, False, seed=5)
    before = cc.LAUNCHES["cull_beam"]
    with pytest.raises(ValueError, match="shared memory"):
        cc.cull_beam(t["o3"], t["d3"], t["bmin"], t["bmax"], le)
    assert cc.LAUNCHES["cull_beam"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
def test_beam_pair_equals_exact_pair_on_card(stream, cuda_device):
    """atrium(2_200) at M = 32: the beam-culled pair launches K3b (and no
    K3) and answers exactly as the exact-culled pair on the card."""
    scene = build_scene_tensors(atrium(2_200, seed=5), device=cuda_device)
    ca = build_clusters(*(x.cpu().numpy() for x in (scene.tri_v0, scene.tri_v1,
                                                      scene.tri_v2)), 32)
    rng = np.random.default_rng(8)
    lo, hi = scene.world_min.cpu().numpy(), scene.world_max.cpu().numpy()
    o = torch.tensor(rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), (1280, 3)),
                     dtype=torch.float32, device=cuda_device)
    d = torch.tensor(rng.normal(size=(1280, 3)), dtype=torch.float32, device=cuda_device)
    outs = {}
    for beam in (False, True):
        cf, af = cc.make_cluster_intersectors(scene, clusters=ca, stream=stream, beam=beam)
        before = dict(cc.LAUNCHES)
        res = cf(o, d)
        occ = af(o, d, torch.where(res.hit, res.t * 0.9, 1e9),
                 torch.full((1280,), -1, dtype=torch.int32, device=cuda_device))
        torch.cuda.synchronize()
        grew = {k for k, n in cc.LAUNCHES.items() if n > before[k]}
        assert grew == {"cull_beam" if beam else "cull", *cc.ROUTES[cf.route]}
        outs[beam] = (res, occ)
    (a, a_occ), (b, b_occ) = outs[False], outs[True]
    for f in ("hit", "t", "tid", "u", "v"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a_occ, b_occ) and bool(a.hit.any())


@pytest.mark.cuda
def test_onehot_backward_deterministic_on_card(cuda_device):
    """The dense backward's one-hot fetch and the light row's on the card:
    two fwd+bwd runs of a weighted Cornell loss give bitwise-equal
    gradients, and so does a run under ``set_float32_matmul_precision
    ("high")`` (TF32 would round the fetched rows, and the recompute's t,
    u, v with them: the products are forced to full FP32)."""
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA as cam
    from chiaroscuro_tpu_torch.scene.scene_arrays import params_from_numpy

    assert ic._BWD_ONEHOT is None        # the size rule: 36 triangles, the product
    scene = build_scene_tensors(cornell_box(), device=cuda_device)

    def grads():
        p = params_from_numpy({k: getattr(scene, k).cpu().numpy()
                               for k in ("kd", "ke", "tri_v0")}, cuda_device)
        s = scene.replace(**p)
        cf, af = make_intersectors(s, "dense")
        xs, ys = _pixels(64, 64, cuda_device)
        img = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], 64, 64,
                             xs, ys, 0, 2, 0, 3, (0.0, 0.0, 0.0), cf, af)
        (img * torch.linspace(0.5, 1.5, img.numel(), device=cuda_device)
         .reshape(img.shape)).mean().backward()
        return {k: v.grad.cpu() for k, v in p.items()}

    runs = [grads(), grads()]
    torch.set_float32_matmul_precision("high")
    try:
        runs.append(grads())
    finally:
        torch.set_float32_matmul_precision("highest")
    for k, g in runs[0].items():
        assert float(g.abs().max()) > 0, k
        for other in runs[1:]:
            assert torch.equal(_bits(other[k]), _bits(g)), k


# ---------------------------------------------------------------------------
# The gather's backward: the sort-by-id segmented row sum.
# ---------------------------------------------------------------------------


def _scatter_case(dev, lanes, rows, width, zero_share=0.6):
    """A (width, lanes) cotangent and int32 ids, ``zero_share`` of them 0
    (a wavefront's misses and dead rows), the rest uniform over rows."""
    rng = np.random.default_rng(lanes + width)
    tid = rng.integers(0, rows, lanes).astype(np.int32)
    tid[rng.random(lanes) < zero_share] = 0
    ct = rng.normal(size=(width, lanes)).astype(np.float32)
    return torch.from_numpy(ct).to(dev), torch.from_numpy(tid).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes, rows, width", [
    (921_600, 261_396, 32),     # the 262k inverse-rendering step's wavefront
    (B0 * 128, 3_000, 9),       # the triangle rows' width
    (1_001, 50, 40),            # a ragged count; two column groups
])
def test_scatter_rows_equals_plain_on_card(lanes, rows, width, cuda_device):
    """The segmented sum bitwise equal to its plain version (run on the
    CPU), 60% of the lanes at id 0; two calls bitwise equal, each counted
    once in ``LAUNCHES["scatter_rows"]``; rows no lane names stay 0."""
    from chiaroscuro_tpu_torch.ops import scatter_cuda as sc

    ct, tid = _scatter_case(cuda_device, lanes, rows, width)
    before = sc.LAUNCHES["scatter_rows"]
    a = sc.scatter_rows_sum(ct, tid, rows)
    b = sc.scatter_rows_sum(ct, tid, rows)
    torch.cuda.synchronize()
    assert sc.LAUNCHES["scatter_rows"] == before + 2
    assert torch.equal(_bits(a), _bits(b))
    want = sc.scatter_rows_sum_plain(ct.cpu(), tid.cpu(), rows)
    assert torch.equal(_bits(a.cpu()), _bits(want))
    named = torch.bincount(tid.long(), minlength=rows) > 0
    assert bool(a[named].abs().sum(1).gt(0).all()) and not bool(a[~named].any())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["ct_dtype", "tid_dtype", "tid_on_cpu", "ct_strided",
                                   "ct_shape"])
def test_scatter_rows_raises_on_card(fault, cuda_device):
    """A wrong dtype, device, layout or shape raises ValueError before any
    launch."""
    from chiaroscuro_tpu_torch.ops import scatter_cuda as sc

    ct, tid = _scatter_case(cuda_device, 4_096, 100, 32)
    if fault == "ct_dtype":
        ct = ct.double()
    elif fault == "tid_dtype":
        tid = tid.long()
    elif fault == "tid_on_cpu":
        tid = tid.cpu()
    elif fault == "ct_strided":
        ct = ct.T.contiguous().T
    else:
        ct = ct[:, 1:].contiguous()
    before = sc.LAUNCHES["scatter_rows"]
    with pytest.raises(ValueError):
        sc.scatter_rows_sum(ct, tid, 100)
    assert sc.LAUNCHES["scatter_rows"] == before


@pytest.mark.cuda
def test_cluster_backward_deterministic_on_card(cuda_device):
    """The cluster path's closest-hit backward on the card (atrium(2_200),
    K3 + K4, the gather's backward the segmented sum, one a bounce): two
    fwd+bwd runs give bitwise-equal kd/ke gradients, which agree with the
    CPU's at test_card_gradients_match_cpu's bound (rtol 1e-3, atol 1e-4 x
    the largest entry)."""
    from chiaroscuro_tpu_torch.ops import scatter_cuda as sc
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA as cam

    def grads(dev):
        scene = build_scene_tensors(atrium(2_200, seed=5), device=dev)
        kd = scene.kd.clone().requires_grad_()
        ke = scene.ke.clone().requires_grad_()
        s = scene.replace(kd=kd, ke=ke)
        cf, af = make_intersectors(s, "cluster")
        xs, ys = _pixels(64, 48, dev)
        n0 = sc.LAUNCHES["scatter_rows"]
        img = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], 64, 48,
                             xs, ys, 0, 1, 3, 3, (0.0, 0.0, 0.0), cf, af)
        (img * torch.linspace(0.5, 1.5, img.numel(), device=dev)
         .reshape(img.shape)).mean().backward()
        if dev.type == "cuda":
            assert sc.LAUNCHES["scatter_rows"] - n0 == 3
        return {"kd": kd.grad.cpu(), "ke": ke.grad.cpu()}

    runs = [grads(cuda_device), grads(cuda_device)]
    ref = grads(torch.device("cpu"))
    for k, g in runs[0].items():
        assert torch.equal(_bits(runs[1][k]), _bits(g)), k
        scale = float(ref[k].abs().max())
        if scale > 0:
            torch.testing.assert_close(g, ref[k], rtol=1e-3, atol=1e-4 * scale)
    assert float(ref["ke"].abs().max()) > 0


def _x1_inputs(dev):
    """Seeded rays and 300 boxes (KB = 384) in the unit cube; row 3's rays
    start outside and point away, so only its padded columns hit."""
    rng = np.random.default_rng(12)
    lo = rng.uniform(0.0, 0.9, (300, 3))
    boxes = xc.pack_cull_boxes(lo.astype(np.float32),
                               (lo + rng.uniform(0.01, 0.1, (300, 3))).astype(np.float32))
    o3 = rng.uniform(-0.2, 1.2, (3, B0, 128))
    d3 = rng.normal(size=(3, B0, 128))
    d3[:, 5, :7] = 0.0                      # axis-parallel lanes: the clamped 1/d
    o3[:, 3], d3[:, 3] = 5.0, np.abs(d3[:, 3]) + 0.1
    tmax = rng.uniform(0.0, 1.5, (B0, 128))
    return {k: torch.tensor(x, dtype=torch.float32, device=dev)
            for k, x in dict(o3=o3, d3=d3, tmax=tmax, boxes=boxes).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("with_tmax", [False, True])
def test_x1_equals_plain_on_card(with_tmax, cuda_device):
    """X1 exactly equal to its plain version, padded columns 1.0 in every
    row, a row that hits only padded columns, and its row hits equal to
    K3's hit mask."""
    t = _x1_inputs(cuda_device)
    tmax = t["tmax"] if with_tmax else None
    before = xc.LAUNCHES["cull_rowhit"]
    got = xc.cull_rowhit(t["o3"], t["d3"], t["boxes"], tmax)
    torch.cuda.synchronize()
    assert xc.LAUNCHES["cull_rowhit"] == before + 1
    assert torch.equal(got, xc.cull_rowhit_plain(t["o3"], t["d3"], t["boxes"], tmax))
    assert bool((got[:, 300:] == 1.0).all()) and not bool(got[3, :300].any())
    assert 0.05 < float(got[:, :300].mean()) < 0.95
    bmin, bmax = t["boxes"][:300, 0:3].contiguous(), t["boxes"][:300, 3:6].contiguous()
    assert torch.equal(got[:, :300] > 0, xc.k3_rowhit(t["o3"], t["d3"], bmin, bmax, tmax))


@pytest.mark.cuda
@pytest.mark.parametrize("trip", [0, 1, 5, 16, 19, 40])
def test_x2_equals_plain_on_card(trip, cuda_device):
    """X2 bitwise equal to its plain version, trip = 0 (zeros) and trip > K
    (the last block again) included."""
    x = torch.tensor(np.random.default_rng(trip).random((dm.K * dm.M, dm.W)),
                     dtype=torch.float32, device=cuda_device)
    meta = torch.tensor([[trip, 0]], dtype=torch.int32, device=cuda_device)
    before = dm.LAUNCHES["dma_min"]
    got = dm.dma_min(meta, x)
    torch.cuda.synchronize()
    assert dm.LAUNCHES["dma_min"] == before + 1
    want = dm.dma_min_plain(meta, x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if trip == 0:
        assert not bool(got.any())
    ref = x.double().reshape(dm.K, dm.M, dm.W)[[min(j, dm.K - 1) for j in range(trip)]].sum((0, 1))
    torch.testing.assert_close(got[0].double(), ref, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_card_gradients_match_cpu(cuda_device):
    """kd/ke/tri_v0 gradients of a weighted Cornell loss through K1 on the
    card against the same loss on the CPU (the plain K1 in the same
    autograd Function): rtol 1e-3, atol 1e-4 x the largest entry (CUDA and
    CPU transcendentals differ by ulps, ROADMAP section 3)."""
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA as cam
    from chiaroscuro_tpu_torch.scene.scene_arrays import params_from_numpy

    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        scene = build_scene_tensors(cornell_box(), device=dev)
        p = params_from_numpy({k: getattr(scene, k).cpu().numpy()
                               for k in ("kd", "ke", "tri_v0")}, dev)
        s = scene.replace(**p)
        cf, af = make_intersectors(s, "dense")
        ys, xs = torch.meshgrid(torch.arange(16, device=dev), torch.arange(16, device=dev),
                                indexing="ij")
        img = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], 16, 16,
                             xs.reshape(-1), ys.reshape(-1), 0, 2, 0, 3, (0.0, 0.0, 0.0),
                             cf, af)
        (img * torch.linspace(0.5, 1.5, img.numel(), device=dev).reshape(img.shape)).mean().backward()
        grads[dev.type] = {k: v.grad.cpu() for k, v in p.items()}
    for k, ref in grads["cpu"].items():
        scale = float(ref.abs().max())
        assert scale > 0, k
        torch.testing.assert_close(grads["cuda"][k], ref, rtol=1e-3, atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# The Phong extension, spp_batch and the Phong gradients on the card.
# ---------------------------------------------------------------------------


def _glossy(meshes, ks, ns, only=None):
    for m in meshes:
        if not m.is_light and (only is None or only in m.name):
            m.specular = np.full(3, ks, np.float32)
            m.shininess = ns
    return meshes


def _phong_case(path, dev):
    """(scene, camera, intersector pair) of a Phong scene on ``dev``: the
    Cornell box with glossy blocks on the dense pair, or atrium(2_200)
    with every non-emissive mesh glossy on the cluster pair's route."""
    from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA

    if path == "dense":
        s = build_scene_tensors(_glossy(cornell_box(), 0.5, 50.0, only="block"),
                                enable_specular=True, device=dev)
        return s, CORNELL_CAMERA, make_intersectors(s, "dense")
    s = build_scene_tensors(_glossy(atrium(2_200, seed=5), 0.3, 40.0),
                            enable_specular=True, device=dev)
    return s, ATRIUM_CAMERA, cc.make_cluster_intersectors(s, stream=path == "stream")


def _pixels(xres, yres, dev):
    ys, xs = torch.meshgrid(torch.arange(yres, device=dev), torch.arange(xres, device=dev),
                            indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "resident", "stream"])
def test_phong_render_card_matches_cpu(path, cuda_device):
    """A Phong render through K1/K2 (Cornell, glossy blocks), K4/K5 and
    K6/K7 (atrium(2_200), every mesh glossy) on the card against the same
    render on the CPU: the pixels inside rtol 1e-3 within 1e-4 x the mean
    radiance, the whole image within 1e-3 x it (a path that an ulp of a
    CUDA vs CPU transcendental turned, ROADMAP section 3), at most 0.5% of
    the pixels outside rtol 1e-3."""
    from chiaroscuro_tpu_torch.render.renderer import render_samples

    imgs = {}
    for dev in (cuda_device, torch.device("cpu")):
        s, cam, pair = _phong_case(path, dev)
        before = {**ic.LAUNCHES, **cc.LAUNCHES}
        with torch.no_grad():
            imgs[dev.type] = render_samples(
                s, cam["eye"], cam["center"], cam["up"], cam["yview"], 48, 32,
                *_pixels(48, 32, dev), 0, 2, 0, 3, (0.0, 0.0, 0.0), *pair).cpu()
        if dev.type == "cuda":
            names = ({"dense": ("closest", "any")}.get(path) or cc.ROUTES[path])
            after = {**ic.LAUNCHES, **cc.LAUNCHES}
            assert all(after[n] > before[n] for n in names), (path, before, after)
    img, ref = imgs["cuda"], imgs["cpu"]
    assert torch.isfinite(img).all() and float(ref.mean()) > 1e-3
    inside = torch.isclose(img, ref, rtol=1e-3, atol=0.0).all(dim=-1)
    d = (img - ref).abs()
    assert float(d[inside].mean()) <= 1e-4 * float(ref.mean())
    assert float(d.mean()) <= 1e-3 * float(ref.mean())
    assert float((~inside).float().mean()) <= 0.005


@pytest.mark.cuda
def test_spp_batch_on_card(cuda_device):
    """spp_batch=16 against 1 on Cornell 64x64 x 16 spp x k 6 through
    K1/K2: mean relative <= 1e-6 and max |d| <= 1e-5 x max (only the
    order of the float sums differs), and 6 K1 launches against 96."""
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA as cam

    s = build_scene_tensors(cornell_box(), device=cuda_device)
    pair = make_intersectors(s, "dense")
    out = {}
    for sb in (1, 16):
        n0 = ic.LAUNCHES["closest"]
        with torch.no_grad():
            out[sb] = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], 64,
                                     64, *_pixels(64, 64, cuda_device), 0, 16, 0, 6,
                                     (0.0, 0.0, 0.0), *pair, spp_batch=sb)
        assert ic.LAUNCHES["closest"] - n0 == 96 // sb, sb
    d = (out[16] - out[1]).abs()
    assert float((d / out[1].abs().clamp_min(1e-30)).mean()) <= 1e-6
    assert float(d.max()) <= 1e-5 * float(out[1].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "resident"])
def test_phong_gradients_card_match_cpu(path, cuda_device):
    """kd/ke/ks/shininess gradients of a Phong render's weighted mean
    through K1 (Cornell) and K4 (atrium(2_200)) on the card against the
    CPU's: relative L1 <= 1e-3 each (the smoke's bound), all finite, ks and
    shininess non-zero."""
    from chiaroscuro_tpu_torch.render.renderer import render_samples
    from chiaroscuro_tpu_torch.scene.scene_arrays import params_from_numpy

    fields = ("kd", "ke", "ks", "shininess")
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        scene, cam, _ = _phong_case(path, dev)
        p = params_from_numpy({k: getattr(scene, k).cpu().numpy() for k in fields}, dev)
        s = scene.replace(**p)
        pair = (make_intersectors(s, "dense") if path == "dense"
                else cc.make_cluster_intersectors(s, stream=False))
        img = render_samples(s, cam["eye"], cam["center"], cam["up"], cam["yview"], 24, 16,
                             *_pixels(24, 16, dev), 0, 2, 0, 2, (0.0, 0.0, 0.0), *pair)
        w = torch.linspace(0.5, 1.5, img.numel(), device=dev).reshape(img.shape)
        (img * w).mean().backward()
        grads[dev.type] = {k: v.grad.cpu().double() for k, v in p.items()}
    for k, ref in grads["cpu"].items():
        got = grads["cuda"][k]
        assert torch.isfinite(got).all(), k
        scale = float(ref.abs().sum())
        assert scale > 0 or k == "kd", k
        assert float((got - ref).abs().sum()) <= 1e-3 * max(scale, 1e-30), k
    assert float(grads["cpu"]["ks"].abs().sum()) > 0
    assert float(grads["cpu"]["shininess"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# B1/B2: the threaded-BVH walks.
# ---------------------------------------------------------------------------


def _bvh_case(name, dev):
    """A scene's BVH and 1,000 seeded rays around it, then the axis-aligned
    rays that start on the planes of the BVH's root box (0 * inf = NaN in
    the slab test: the box must miss), with seeded tmax and exclude ids."""
    from chiaroscuro_tpu_torch.accel import bvh

    if name == "cornell":
        scene, leaf = build_scene_tensors(cornell_box(), device=dev), 4
    else:
        scene, leaf = build_scene_tensors(atrium(2_200, seed=5), device=dev), 8
    b = bvh.build_bvh(scene, leaf_size=leaf)
    rng = np.random.default_rng(21)
    lo, hi = b.bbox_min[0].cpu().numpy(), b.bbox_max[0].cpu().numpy()   # the root box
    o = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (1000, 3))
    d = rng.normal(size=(1000, 3))
    mid = lo + np.array([0.3, 0.45, 0.6]) * (hi - lo)
    for a in range(3):
        for x in (lo[a], hi[a]):
            for e in np.concatenate([np.eye(3), -np.eye(3)]):
                if e[a] != 0:
                    continue            # only directions parallel to the plane
                p = mid.copy()
                p[a] = x
                o = np.concatenate([o, p[None]])
                d = np.concatenate([d, e[None]])
    n = len(o)
    tmax = rng.uniform(0.05, 1.0, n) * float(np.linalg.norm(hi - lo))
    excl = rng.integers(0, scene.n_tris, n)

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)

    return scene, b, t(o), t(d), t(tmax), t(excl, torch.int32)


def _bvh_rays(case, dev):
    """(BVH, origins, dirs, tmax, exclude ids) of a B1/B2 case: the scenes'
    rays of :func:`_bvh_case` ("cornell", "atrium"), the atrium's in a
    seeded random order, its first R rays (R of 0, 1, 33 and 4,097, from
    4,097 seeded rays about its root box), "long": two warps of rays in
    which one lane walks the atrium's longest seeded walk and the other 31
    miss the root box, and "ties" (:func:`_bvh_ties`)."""
    from chiaroscuro_tpu_torch.accel import bvh

    if case == "ties":
        return _bvh_ties(dev)
    name = "cornell" if case == "cornell" else "atrium"
    _, b, o, d, tmax, excl = _bvh_case(name, dev)
    if case in ("cornell", "atrium"):
        return b, o, d, tmax, excl
    rng = np.random.default_rng(33)
    if case == "random order":
        perm = torch.from_numpy(rng.permutation(o.shape[0])).to(dev)
        return b, o[perm], d[perm], tmax[perm], excl[perm]
    lo, hi = b.bbox_min[0].cpu().numpy(), b.bbox_max[0].cpu().numpy()
    n = 4097
    oo = torch.tensor(rng.uniform(lo, hi, (n, 3)), dtype=torch.float32, device=dev)
    dd = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32, device=dev)
    tm = torch.tensor(rng.uniform(0.05, 1.0, n) * float(np.linalg.norm(hi - lo)),
                      dtype=torch.float32, device=dev)
    ex = torch.tensor(rng.integers(0, 2_200, n), dtype=torch.int32, device=dev)
    if case.startswith("R="):
        r = int(case[2:])
        return b, oo[:r], dd[:r], tm[:r], ex[:r]
    # "long": the longest of the seeded walks at lanes 5 and 32 + 17.
    steps = bvh.bvh_closest(b, oo, dd, counts=True)[5][0]
    k = int(torch.argmax(steps))
    away = torch.tensor(hi + (hi - lo), dtype=torch.float32, device=dev)
    o2 = away.expand(64, 3).clone()
    d2 = torch.ones((64, 3), dtype=torch.float32, device=dev)
    t2 = tm[:64].clone()
    e2 = ex[:64].clone()
    for lane in (5, 49):
        o2[lane], d2[lane], t2[lane], e2[lane] = oo[k], dd[k], float("inf"), -1
    return b, o2, d2, t2, e2


def _bvh_ties(dev):
    """"ties": 500 random triangles twice over (ids i and i + 500 tie
    exactly), each leaf's slots reversed so that the larger id of a pair is
    walked first, and 2,000 rays through the triangles' centroids."""
    import dataclasses

    from chiaroscuro_tpu_torch.accel import bvh
    from chiaroscuro_tpu_torch.scene.obj_loader import Mesh

    rng = np.random.default_rng(41)
    v = [torch.cat([x, x]) for x in _soup_tris(rng, 500, dev)]
    pos = torch.stack(v, dim=1).reshape(-1, 3).cpu().numpy()
    f32 = np.float32
    soup = Mesh("soup", pos, np.tile(f32([0, 0, 1]), (3000, 1)), np.zeros((3000, 2), f32),
                np.arange(3000, dtype=np.int32).reshape(1000, 3), f32([0.5] * 3), f32([0] * 3),
                f32([0] * 3), f32([0] * 3), 1.0)
    b = bvh.build_bvh(build_scene_tensors([soup], device=dev), leaf_size=8)
    perm = torch.arange(b.tri_order.numel())
    for s, c in zip(b.leaf_start.tolist(), b.leaf_count.tolist()):
        if c > 0:
            perm[s:s + c] = torch.arange(s + c - 1, s - 1, -1)
    perm = perm.to(dev)
    b = dataclasses.replace(b, tri_order=b.tri_order[perm].contiguous(),
                            tris=b.tris[perm].contiguous())
    cent = ((v[0] + v[1] + v[2]) / 3.0)[torch.from_numpy(rng.integers(0, 500, 2000)).to(dev)]
    o = cent + torch.tensor(rng.normal(size=(2000, 3)), dtype=torch.float32, device=dev)
    tmax = torch.full((2000,), 1e4, device=dev)
    excl = torch.tensor(rng.integers(0, 1000, 2000), dtype=torch.int32, device=dev)
    return b, o, cent - o, tmax, excl


BVH_CASES = ["cornell", "atrium", "random order", "R=0", "R=1", "R=33", "R=4097", "long", "ties"]


def _bvh_equal(bvh_cuda, bvh, b, o, d, tmax, excl):
    """B1 and B2 on the card against the plain walk: bitwise, with equal
    counts, one launch each (none for no rays).  Returns the plain walk's
    ((hit, t, tid, u, v, counts), (occluded, counts))."""
    n0 = dict(bvh_cuda.LAUNCHES)
    launches = int(o.shape[0] > 0)
    got = bvh_cuda.closest_bvh(b, o, d, counts=True)
    want = bvh.bvh_closest(b, o, d, counts=True)
    assert bvh_cuda.LAUNCHES["bvh_closest"] == n0["bvh_closest"] + launches
    for f, a, w in zip(("hit", "t", "tid", "u", "v"), got[:5], want[:5]):
        assert torch.equal(_bits(a), _bits(w)), f
    assert torch.equal(got[5][0], want[5][0]) and torch.equal(got[5][1], want[5][1])
    occ, counts = bvh_cuda.any_bvh(b, o, d, tmax, excl, counts=True)
    ref = bvh.bvh_any(b, o, d, tmax, excl, counts=True)
    assert bvh_cuda.LAUNCHES["bvh_any"] == n0["bvh_any"] + launches
    assert torch.equal(occ, ref[0])
    assert torch.equal(counts[0], ref[1][0]) and torch.equal(counts[1], ref[1][1])
    return want, ref


@pytest.mark.cuda
@pytest.mark.parametrize("case", BVH_CASES)
def test_bvh_kernels_equal_plain_on_card(case, cuda_device):
    """B1 and B2 bitwise equal to the plain walk (accel/bvh.py) on the
    card, with equal per-ray step and leaf-test counts; each launch
    counted, the plain walk launching nothing, and no launch for no rays."""
    from chiaroscuro_tpu_torch.accel import bvh
    from chiaroscuro_tpu_torch.ops import bvh_cuda

    b, o, d, tmax, excl = _bvh_rays(case, cuda_device)
    want, ref = _bvh_equal(bvh_cuda, bvh, b, o, d, tmax, excl)
    assert want[0].shape[0] == {"R=0": 0, "R=1": 1, "R=33": 33, "R=4097": 4097,
                                "long": 64}.get(case, o.shape[0])
    if case == "R=4097":
        assert 0.05 < float(ref[0].float().mean()) < 0.95
    if case in ("cornell", "atrium"):
        assert 0.2 < float(want[0].float().mean()) < 0.95
        assert 0.05 < float(ref[0].float().mean()) < 0.95
        # The on-plane axis rays: NaN in the root box's slab test, so no
        # step past the root.
        on_plane = slice(1000, None)
        assert int(want[5][0][on_plane].max()) == 1 and not bool(want[0][on_plane].any())
    if case == "long":
        steps = want[5][0]
        others = torch.ones(64, dtype=torch.bool, device=cuda_device)
        others[[5, 49]] = False
        assert int(steps[others].max()) == 1 and int(steps[5]) >= 30
    if case == "ties":
        # Every hit is the least id of its exact tie, though the larger is walked first.
        assert float(want[0].float().mean()) > 0.9
        assert int(want[2][want[0]].max()) < 500


@pytest.fixture(scope="module")
def sponza_bvh_pass():
    """Every query of one pass of the benchmark's Sponza-class frame
    (``benchmarks/configs/sponza_atrium_262k_bvh.json``: the 262k atrium at
    1280x720, k 3) through ``intersector bvh``, recorded at the pair's
    entry: (BVH, the reference's exact queries, [(kind, args)])."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import contextlib
    import io
    import json
    import os

    from benchmarks.harness import program
    from benchmarks.reference import accel as ref_accel
    from benchmarks.reference import scene as ref_scene
    from chiaroscuro_tpu_torch.render.renderer import Renderer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = json.load(open(os.path.join(root, "benchmarks/configs/sponza_atrium_262k_bvh.json")))
    cfg["name"] = "sponza_atrium_262k_bvh"
    meshes, textures = program.scene_inputs(cfg)
    scene, _ = program.port_scene(meshes, textures, "cuda")
    r = Renderer(scene, program.render_config(cfg, 1, 1264210757, "cuda"))
    closest_fn, any_fn = r.intersectors
    queries = []

    def closest(o, d):
        queries.append(("closest", (o.contiguous().clone(), d.contiguous().clone())))
        return closest_fn(o, d)

    def occluded(o, d, tmax, excl):
        queries.append(("any", (o.contiguous().clone(), d.contiguous().clone(), tmax.clone(),
                                excl.clone())))
        return any_fn(o, d, tmax, excl)

    closest.bvh = closest_fn.bvh
    r.intersectors = (closest, occluded)
    with contextlib.redirect_stdout(io.StringIO()):
        r.ray_trace()
    groups = ref_accel.Groups(ref_scene.flatten(meshes, textures, "cuda"))
    yield closest_fn.bvh, groups, queries
    del r, scene, groups, queries
    torch.cuda.empty_cache()


def _bvh_sentinel_launch(b, args):
    """B1 (two args) or B2 (four) launched straight into outputs filled with
    sentinels (NaN floats, -1 ids and counts, 7 flags), with counts; a lane
    the kernel never writes keeps them."""
    from chiaroscuro_tpu_torch.accel.bvh import step_limit
    from chiaroscuro_tpu_torch.ops import bvh_cuda

    lib, _ = bvh_cuda.build()
    o, d = args[0], args[1]
    R, dev = o.shape[0], o.device

    def fill(value, dtype):
        return torch.full((R,), value, dtype=dtype, device=dev)

    steps, tests = fill(-1, torch.int32), fill(-1, torch.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if len(args) == 2:
        out = (fill(7, torch.uint8), fill(float("nan"), torch.float32), fill(-1, torch.int32),
               fill(float("nan"), torch.float32), fill(float("nan"), torch.float32))
        err = lib.bvh_closest_launch(*bvh_cuda._tables(b), o.data_ptr(), d.data_ptr(), R,
                                     step_limit(b), *(x.data_ptr() for x in out),
                                     steps.data_ptr(), tests.data_ptr(), stream)
    else:
        tmax, excl = args[2].contiguous(), args[3].to(torch.int32).contiguous()
        out = (fill(7, torch.uint8),)
        err = lib.bvh_any_launch(*bvh_cuda._tables(b), o.data_ptr(), d.data_ptr(),
                                 tmax.data_ptr(), excl.data_ptr(), R, step_limit(b),
                                 out[0].data_ptr(), steps.data_ptr(), tests.data_ptr(), stream)
    assert err == 0, lib.bvh_traverse_error_string(err)
    torch.cuda.synchronize()
    return out, (steps, tests)


@pytest.mark.cuda
def test_bvh_kernels_equal_plain_on_a_sponza_pass(sponza_bvh_pass):
    """B1 and B2 bitwise equal to the plain walk, outputs and per-ray step
    and leaf-test counts, on every query of one Sponza-size pass (three
    closest and three shadow wavefronts of 921,600 rays), launched into
    sentinel-filled outputs so that a lane never written shows; and under
    ``counting()`` the wrappers record one entry a launch whose sums are
    the plain walk's."""
    from chiaroscuro_tpu_torch.accel import bvh
    from chiaroscuro_tpu_torch.ops import bvh_cuda
    from chiaroscuro_tpu_torch.utils.profiling import counting

    b, _, queries = sponza_bvh_pass
    assert [k for k, _ in queries] == ["closest", "any"] * 3
    sums = []
    for kind, args in queries:
        assert args[0].shape[0] == 1280 * 720
        out, counts = _bvh_sentinel_launch(b, args)
        if kind == "closest":
            want = bvh.bvh_closest(b, *args, counts=True)
            assert int((out[0] > 1).sum()) == 0
            assert torch.equal(out[0].bool(), want[0])
            for f, got, ref in zip(("t", "tid", "u", "v"), out[1:], want[1:5]):
                assert torch.equal(_bits(got), _bits(ref)), f
        else:
            want = bvh.bvh_any(b, *args, counts=True)
            assert int((out[0] > 1).sum()) == 0
            assert torch.equal(out[0].bool(), want[0])
        wc = want[-1]
        assert torch.equal(counts[0], wc[0]) and torch.equal(counts[1], wc[1])
        sums.append({"kernel": "bvh_" + kind, "rays": args[0].shape[0],
                     "steps": int(wc[0].sum()), "tests": int(wc[1].sum())})
    with counting() as entries:
        for kind, args in queries:
            (bvh_cuda.closest_bvh if kind == "closest" else bvh_cuda.any_bvh)(b, *args)
    assert entries == sums


@pytest.mark.cuda
def test_bvh_sponza_pass_matches_reference(sponza_bvh_pass):
    """Every query of the Sponza-size pass through B1/B2 against the
    benchmark reference's exact queries (``benchmarks/reference/accel.py``):
    the same hits, ids and t bits, the same occlusion.  Before the pad and
    the least-(t, id) rule, this pass's queries differed on 3 closest rays
    and 85 shadow rays of 5.5 M, about one path in 10^4: the cell's ~640
    passes in 30 s carry each check pixel's error to 5% of them."""
    from chiaroscuro_tpu_torch.ops import bvh_cuda

    b, groups, queries = sponza_bvh_pass
    for kind, args in queries:
        if kind == "closest":
            hit, t, tid, _, _ = bvh_cuda.closest_bvh(b, *args)
            rh, rt, rtid, _, _ = groups.closest(*args)
            assert torch.equal(hit, rh)
            assert torch.equal(tid[hit].long(), rtid[hit])
            assert torch.equal(_bits(t[hit]), _bits(rt[hit]))
        else:
            o, d, tmax, excl = args
            assert torch.equal(bvh_cuda.any_bvh(b, *args),
                               groups.occluded(o, d, tmax, excl.long()))


@pytest.mark.cuda
def test_bvh_kernels_on_concurrent_streams(cuda_device):
    """B1 and B2 launched in turns on two streams, each stream's launches
    queued behind the other's, stay bitwise equal to the plain walk: each
    stream has its own work counters."""
    from chiaroscuro_tpu_torch.accel import bvh
    from chiaroscuro_tpu_torch.ops import bvh_cuda

    cases = [_bvh_rays(c, cuda_device) for c in ("R=4097", "random order")]
    want = [(bvh.bvh_closest(b, o, d), bvh.bvh_any(b, o, d, tm, ex)) for b, o, d, tm, ex in cases]
    streams = [torch.cuda.Stream(cuda_device) for _ in cases]
    torch.cuda.synchronize()
    got = [[] for _ in cases]
    for _ in range(3):
        for k, ((b, o, d, tm, ex), stream) in enumerate(zip(cases, streams)):
            with torch.cuda.stream(stream):
                got[k].append((bvh_cuda.closest_bvh(b, o, d), bvh_cuda.any_bvh(b, o, d, tm, ex)))
    torch.cuda.synchronize()
    for k, (closest, occ) in enumerate(want):
        for hit, blocked in got[k]:
            for a, w in zip(hit, closest):
                assert torch.equal(_bits(a), _bits(w))
            assert torch.equal(blocked, occ)


@pytest.mark.cuda
def test_bvh_render_card_matches_cpu(cuda_device):
    """atrium(2_200) through ``intersector bvh``: B1/B2 launch once per
    bounce, and the card's image is within the render bound of the CPU's
    (mean |d| <= 1e-4 x mean over the pixels inside rtol 1e-3, 1e-3 over
    all, at most 0.5% outside: the smoke's atrium bound)."""
    from chiaroscuro_tpu_torch.ops import bvh_cuda
    from chiaroscuro_tpu_torch.render.renderer import render_image
    from chiaroscuro_tpu_torch.scene.config import RenderConfig
    from chiaroscuro_tpu_torch.scene.scene_arrays import load_scene

    tokens = ["input", "synthetic:atrium:2200", "xres", "64", "yres", "36", "samples", "2",
              "k", "2", "intersector", "bvh", "VP", "1.8", "4.2", "5.0", "LA", "24", "3.2",
              "6.8", "UP", "0", "1", "0", "yview", "0.9"]
    imgs = {}
    for dev in (cuda_device, torch.device("cpu")):
        cfg = RenderConfig.from_tokens(tokens + ["platform", dev.type])
        n0 = dict(bvh_cuda.LAUNCHES)
        imgs[dev.type] = render_image(load_scene(cfg, dev), cfg).cpu().numpy()
        if dev.type == "cuda":
            assert {k: bvh_cuda.LAUNCHES[k] - n0[k] for k in n0} == \
                {"bvh_closest": 4, "bvh_any": 4}
    img, ref = imgs["cuda"], imgs["cpu"]
    inside = np.isclose(img, ref, rtol=1e-3, atol=0.0).all(axis=-1)
    mean = float(ref.mean())
    assert mean > 0 and np.isfinite(img).all()
    assert float(np.abs(img - ref)[inside].mean()) <= 1e-4 * mean
    assert float(np.abs(img - ref).mean()) <= 1e-3 * mean
    assert (~inside).mean() <= 0.005


# ---------------------------------------------------------------------------
# Tile-sharded rendering and gradient all-reduce (parallel/) on the card.
# ---------------------------------------------------------------------------

SHARDED_INTERSECTORS = ("auto", "cluster", "bvh")   # K1/K2, K3 + K4/K5, B1/B2
# Launches a sample x bounce on each path (the cluster path culls twice).
SHARDED_WANT = {"auto": {"closest": 1, "any": 1},
                "cluster": {"cull": 2, "closest_resident": 1, "any_resident": 1},
                "bvh": {"bvh_closest": 1, "bvh_any": 1}}


def _sharded_cfg(intersector):
    from chiaroscuro_tpu_torch.scene.config import RenderConfig
    from chiaroscuro_tpu_torch.scene.synthetic import ATRIUM_CAMERA as cam

    return RenderConfig(obj_path="synthetic:atrium:2200", xres=160, yres=90, samples=2, k=2,
                        intersector=intersector, vp=cam["eye"], la=cam["center"],
                        up=cam["up"], yview=cam["yview"], use_preview=False)


@pytest.fixture(scope="module")
def sharded_ranks():
    """atrium(2_200)'s 160x90 frames through the three paths and a dense
    Cornell (kd, ke, tri_v0) gradient step, on one NCCL rank and on two
    gloo ranks sharing the card: {world size: per rank, one result a job}."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from chiaroscuro_tpu_torch.parallel.scaling import RankJob, run_ranks
    from chiaroscuro_tpu_torch.scene.builtin import CORNELL_CAMERA as cam
    from chiaroscuro_tpu_torch.scene.config import RenderConfig

    grad_cfg = RenderConfig(obj_path="builtin:cornell_box", xres=64, yres=64, samples=2, k=3,
                            intersector="dense", vp=cam["eye"], la=cam["center"],
                            up=cam["up"], yview=cam["yview"], use_preview=False)
    jobs = [RankJob(_sharded_cfg(n)) for n in SHARDED_INTERSECTORS]
    jobs.append(RankJob(grad_cfg, fields=("kd", "ke", "tri_v0")))
    return {1: run_ranks(1, jobs), 2: run_ranks(2, jobs, backend="gloo")}


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("name", SHARDED_INTERSECTORS)
def test_sharded_frames_on_card_equal_render_samples(name, world, sharded_ranks):
    """The 1-rank NCCL frame and the 2-rank gloo frame (every rank's) are
    bitwise equal to ``render_samples`` over the whole grid in this
    process, and each rank launched its path's kernels."""
    from chiaroscuro_tpu_torch.render.renderer import render_image
    from chiaroscuro_tpu_torch.scene.scene_arrays import load_scene

    cfg = _sharded_cfg(name)
    dev = torch.device("cuda", 0)
    with torch.no_grad():
        want = render_image(load_scene(cfg, dev), cfg).cpu()
    j = SHARDED_INTERSECTORS.index(name)
    for rank in sharded_ranks[world]:
        got = rank[j]
        assert torch.equal(_bits(got["frame"]), _bits(want))
        assert {k: n for k, n in got["launches"].items() if n} == {
            k: m * cfg.samples * cfg.k for k, m in SHARDED_WANT[name].items()}


@pytest.mark.cuda
def test_sharded_gradients_on_card_two_ranks_match_one(sharded_ranks):
    """Two gloo ranks' all-reduced loss and (kd, ke, tri_v0) gradients
    through K1/K2 against one NCCL rank's: loss rtol 1e-6, each gradient
    within 1e-5 relative L1 (only the order of the float sums differs)."""
    one, two = sharded_ranks[1][0][-1], sharded_ranks[2]
    assert one["launches"]["closest"] > 0
    for rank in two:
        got = rank[-1]
        torch.testing.assert_close(got["loss"], one["loss"], rtol=1e-6, atol=0)
        for k, ref in one["grads"].items():
            assert float(ref.abs().sum()) > 0, k
            rel = float((got["grads"][k].double() - ref.double()).abs().sum()
                        / ref.double().abs().sum())
            assert rel <= 1e-5, (k, rel)
