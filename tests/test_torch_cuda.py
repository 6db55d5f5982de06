"""The CUDA and Triton kernels against their plain torch versions, on a
card: K1/K2 (dense), K3 (the cluster cull), K4/K5 (the resident cluster
visits) and K6/K7 (the streaming ones), X1 (the row-hit cull) and X2 (the
double-buffered block fetch); K4/K5 also against K6/K7, and the card's
gradients against the CPU's.

Card-only (marker ``cuda``): without a CUDA device every test skips inside
the fixture.  This file imports no jax, so it also runs on a machine
without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

On the card the kernels must equal their plain versions bitwise: they are
built with ``-fmad=false`` and keep the plain version's operand order; the
cull has no multiply-add to contract.
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


def _tables(name, dev):
    rng = np.random.default_rng(9)
    if name == "cornell":
        s = build_scene_tensors(cornell_box(), device=dev)
        v = (s.tri_v0, s.tri_v1, s.tri_v2)
        attrs = ic._prep_attrs(s)
    else:
        n = 1000
        v0 = rng.uniform(0, 1, (n, 3))
        v = [v0, v0 + rng.normal(scale=0.1, size=(n, 3)), v0 + rng.normal(scale=0.1, size=(n, 3))]
        v = [torch.tensor(x, dtype=torch.float32, device=dev) for x in v]
        attrs = torch.tensor(rng.normal(size=(n, ic.ATTR_K)), dtype=torch.float32, device=dev)
    rows = ic._prep_tris(*v)
    pts = torch.cat(v).cpu().numpy()
    lo, hi = pts.min(0), pts.max(0)
    ext = (hi - lo)[:, None, None]
    o = rng.uniform(lo[:, None, None] - 0.1 * ext, hi[:, None, None] + 0.1 * ext, (3, B0, 128))
    q = dict(
        o3=o, d3=rng.normal(size=(3, B0, 128)),
        tmax=rng.uniform(0, 1.5 * float(ext.max()), (B0, 128)),
    )
    q = {k: torch.tensor(x, dtype=torch.float32, device=dev) for k, x in q.items()}
    q["excl"] = torch.tensor(rng.integers(0, rows.shape[0], (B0, 128)), dtype=torch.int32, device=dev)
    live = torch.ones(B0, dtype=torch.int32, device=dev)
    live[1::3] = 0
    q["live"] = live
    return rows, attrs, q


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell", "soup1000"])
def test_kernels_equal_plain_on_card(name, cuda_device):
    rows, attrs, q = _tables(name, cuda_device)
    before = dict(ic.LAUNCHES)
    got = ic.closest_dense(q["live"], q["o3"], q["d3"], rows, attrs)
    occ = ic.any_dense(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows)
    torch.cuda.synchronize()
    assert ic.LAUNCHES == {"closest": before["closest"] + 1, "any": before["any"] + 1}
    want = ic.closest_dense_plain(q["live"], q["o3"], q["d3"], rows, attrs)
    for field, a, b in zip(("t", "id", "u", "v", "attrs"), got, want):
        assert torch.equal(a, b), field
    assert torch.equal(
        occ, ic.any_dense_plain(q["live"], q["o3"], q["d3"], q["tmax"], q["excl"], rows)
    )
    hit = got[0] < ic.BIG
    assert 0.05 < float(hit.float().mean()) < 0.95
    assert not bool(hit[1::3].any()) and not bool(occ[1::3].any())


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
        "cull": 2, "closest_resident": 0, "any_resident": 0, "closest_cluster": 1,
        "any_cluster": 1}
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


def _atrium_lists(dev, lmax):
    """atrium(2_200, seed=5) at M = 32 with seeded rays and both lists."""
    scene = build_scene_tensors(atrium(2_200, seed=5), device=dev)
    ca = build_clusters(*(x.cpu().numpy() for x in (scene.tri_v0, scene.tri_v1, scene.tri_v2)), 32)
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
    q["lists"] = cc.cull(q["o3"], q["d3"], bmin, bmax, Le)
    q["slists"] = cc.cull(q["o3"], q["d3"], bmin, bmax, Le, tmax=q["tmax"])
    return packed, attrs, q


@pytest.mark.cuda
@pytest.mark.parametrize("lmax", [6, 1536])
def test_resident_kernels_equal_streaming_and_plain(lmax, cuda_device):
    """K4 bitwise equal to K6 and K5 to K7 on the same lists (the same
    function by two memory routes), and both to the plain versions; Lmax 6
    overflows rows into phase 2.  The per-row visit counts: phase 1 and 2
    together never exceed trip + K, and K4 (early exit voted every 8
    visits) visits at least as many clusters as K6 (voted every visit)."""
    packed, attrs, q = _atrium_lists(cuda_device, lmax)
    o3, d3, lists, slists = q["o3"], q["d3"], q["lists"], q["slists"]
    before = dict(cc.LAUNCHES)
    v4, v5, v6, v7 = (torch.zeros(B0, dtype=torch.int32, device=cuda_device) for _ in range(4))
    k4 = cc.closest_resident(*lists, o3, d3, packed, attrs, visits=v4)
    k6 = cc.closest_cluster(*lists, o3, d3, packed, attrs, visits=v6)
    k5 = cc.any_resident(*slists, o3, d3, q["tmax"], q["excl"], packed, visits=v5)
    k7 = cc.any_cluster(*slists, o3, d3, q["tmax"], q["excl"], packed, visits=v7)
    torch.cuda.synchronize()
    assert {k: cc.LAUNCHES[k] - before[k] for k in before} == {
        "cull": 0, "closest_resident": 1, "any_resident": 1, "closest_cluster": 1,
        "any_cluster": 1}
    want = cc.closest_cluster_plain(*lists, o3, d3, packed, attrs)
    for field, a, b, c in zip(("t", "id", "u", "v", "attrs"), k4, k6, want):
        assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a), _bits(c)), field
    assert torch.equal(k5, k7)
    assert torch.equal(k5, cc.any_cluster_plain(*slists, o3, d3, q["tmax"], q["excl"], packed))
    assert bool(lists[0][:, 1].any()) == (lmax == 6)
    K = packed.shape[0]
    for got, ref, meta in ((v4, v6, lists[0]), (v5, v7, slists[0])):
        assert bool((got >= ref).all()) and bool((ref >= 0).all())
        assert bool((got <= meta[:, 0] + K).all()) and int(ref.sum()) > 0


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
