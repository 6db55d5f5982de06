"""The cull K3's arithmetic on the CPU: what ``csrc/cull_rows.cu`` computes,
written out step by step in torch (sign-chosen planes, the normalized
entry, the lanes' minimum over unsigned bit patterns), against the port's
plain sweep ``_rowhit_scan`` and JAX's ``_rowhit_scan(with_near=True)`` on
the same seeded rays; and the lists of rows whose eye lies inside several
boxes against JAX's ``_cull_rows``.  All exact: the slab test has no
multiply-add for XLA to contract, and the kernel's reformulation changes
no rounding (tests/test_torch_cuda.py holds the kernel itself to the plain
sweep on a card).

The JAX package may keep -0.0 where an origin lies on a box plane; numpy's
equality takes -0.0 == +0.0, and the port's entries are +0.0 (checked
bitwise), since the card's radix sort orders -0.0 before +0.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chiaroscuro_tpu.ops.cluster_pallas import _cull_rows as jax_cull_rows
from chiaroscuro_tpu.ops.cluster_pallas import _rowhit_scan as jax_rowhit_scan
from chiaroscuro_tpu.ops.cluster_pallas import _safe_inv as jax_safe_inv
from chiaroscuro_tpu_torch.ops import cluster_cuda as cc

MISS = 0xFFFFFFFF
BIG_BITS = int(torch.tensor(cc.BIG, dtype=torch.float32).view(torch.int32))
CENTER = np.float32(0.5)


def _boxes(rng, K):
    """K seeded boxes in the unit cube, the first min(K, 3) nested around
    the point (0.5, 0.5, 0.5)."""
    lo = rng.uniform(0.0, 0.9, (K, 3))
    hi = lo + rng.uniform(0.02, 0.3, (K, 3))
    for k, s in enumerate((0.1, 0.2, 0.4)[:K]):
        lo[k], hi[k] = 0.5 - s, 0.5 + s
    return lo.astype(np.float32), hi.astype(np.float32)


def _rays(rng, B0, bmin, bmax, axis_parallel, on_planes):
    """(o3, d3) f32 (3, B0, 128): origins around the boxes; with
    ``axis_parallel`` a share of direction components are +-0 (the clamped
    reciprocal); with ``on_planes`` lanes start exactly on a box's entry
    plane (near = -0.0 where the plane is its hi side), and row 0 starts at
    the centre, inside several boxes."""
    n = B0 * 128
    o = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if axis_parallel:
        zero = rng.uniform(size=(n, 3)) < 0.3
        d[zero] = np.where(rng.uniform(size=zero.sum()) < 0.5, 0.0, -0.0)
    if on_planes:
        K = bmin.shape[0]
        for i in range(0, n, 3):
            k, a = rng.integers(K), rng.integers(3)
            inside = bmin[k] + (bmax[k] - bmin[k]) * rng.uniform(0.1, 0.9, 3)
            o[i] = inside.astype(np.float32)
            hi_side = rng.uniform() < 0.5
            o[i, a] = bmax[k, a] if hi_side else bmin[k, a]
            d[i, a] = -abs(d[i, a]) - 0.1 if hi_side else abs(d[i, a]) + 0.1
        o[:128] = CENTER
    planar = lambda x: np.ascontiguousarray(x.T.reshape(3, B0, 128))
    return planar(o), planar(d)


def _kernel_sweep(o3, d3, bmin, bmax, tmax=None):
    """``csrc/cull_rows.cu``'s arithmetic in torch: (count, key, hit)."""
    inv = cc._safe_inv(d3)                                   # clamped_inv
    swap = bmin > bmax                                       # stage_slab
    lo, hi = torch.where(swap, bmax, bmin), torch.where(swap, bmin, bmax)
    tn, tf = [], []
    for a in range(3):
        neg = (inv[a] < 0)[None]                             # (1, B0, 128)
        entry_plane = torch.where(neg, hi[:, a, None, None], lo[:, a, None, None])
        exit_plane = torch.where(neg, lo[:, a, None, None], hi[:, a, None, None])
        tn.append((entry_plane - o3[a][None]) * inv[a][None])
        tf.append((exit_plane - o3[a][None]) * inv[a][None])
    near = torch.maximum(torch.maximum(tn[0], tn[1]), tn[2])    # (K, B0, 128)
    far = torch.minimum(torch.minimum(tf[0], tf[1]), tf[2])
    entry = torch.clamp_min(near, 0.0)
    lane_hit = far >= entry
    if tmax is not None:
        lane_hit = lane_hit & (near <= tmax[None])
    bits = (entry + 0.0).view(torch.int32).to(torch.int64)
    bits = torch.where(lane_hit, bits, MISS)
    warp_min = bits.reshape(*bits.shape[:2], 4, 32).amin(dim=3)  # redux.sync
    u = warp_min.amin(dim=2).T                               # (B0, K)
    hit = u != MISS
    key = torch.clamp_max(u, BIG_BITS).to(torch.int32).contiguous().view(torch.float32)
    return hit.sum(dim=1, dtype=torch.int32), key, hit


CASES = {
    # name: (B0, K, tmax, axis-parallel lanes, origins on planes)
    "one row": (1, 150, False, False, False),
    "one box": (3, 1, False, True, False),
    "K not a multiple of the chunk, tmax": (4, 150, True, False, False),
    "axis-parallel directions": (4, 70, False, True, False),
    "axis-parallel directions, tmax": (4, 70, True, True, False),
    "origins on box planes": (4, 130, False, False, True),
    "origins on box planes, tmax": (4, 130, True, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_arithmetic_equals_plain_and_jax(case):
    B0, K, with_tmax, axis_parallel, on_planes = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    bmin, bmax = _boxes(rng, K)
    o3, d3 = _rays(rng, B0, bmin, bmax, axis_parallel, on_planes)
    tmax = rng.uniform(0.0, 1.0, (B0, 128)).astype(np.float32) if with_tmax else None
    t = lambda x: None if x is None else torch.from_numpy(x)
    count, key, hit = _kernel_sweep(t(o3), t(d3), t(bmin), t(bmax), t(tmax))

    p_count, p_key, p_hit = cc.cull_sweep(t(o3), t(d3), t(bmin), t(bmax), t(tmax))
    assert torch.equal(hit, p_hit) and torch.equal(count, p_count)
    assert torch.equal(key.view(torch.int32), p_key.view(torch.int32))
    assert not bool(torch.signbit(p_key).any())              # +0.0, never -0.0

    j_hit, j_entry = jax_rowhit_scan(
        jnp.asarray(o3), jax_safe_inv(jnp.asarray(d3)), bmin, bmax,
        None if tmax is None else jnp.asarray(tmax), with_near=True)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(j_hit))
    np.testing.assert_array_equal(key.numpy(), np.where(np.asarray(j_hit), j_entry, cc.BIG))
    assert 0 < int(count.sum()) < B0 * K or K == 1
    if on_planes:
        # Lanes on a hi plane facing in give near = -0.0: some entries are 0.
        assert bool((hit & (key == 0.0)).any())


@pytest.mark.parametrize("with_tmax", [False, True])
def test_eye_inside_boxes_lists_tied_at_zero_in_id_order(with_tmax):
    """Every lane of row 0 starts inside the three nested boxes (and others
    around the centre): they tie at entry 0 and are listed first in id
    order, as JAX's ``_cull_rows`` lists them; lanes on box planes add more
    zero entries.  Meta, ids, nears and cutoff exact, with overflow (Lmax
    4) and without (Lmax 1536 > K)."""
    rng = np.random.default_rng(7)
    bmin, bmax = _boxes(rng, 90)
    o3, d3 = _rays(rng, 4, bmin, bmax, False, True)
    tmax = rng.uniform(0.5, 2.0, (4, 128)).astype(np.float32) if with_tmax else None
    t = lambda x: None if x is None else torch.from_numpy(x)
    for lmax in (4, cc.DEFAULT_LMAX):
        got = cc.cull(t(o3), t(d3), t(bmin), t(bmax), min(lmax, 90), tmax=t(tmax))
        ref = jax_cull_rows(jnp.asarray(o3), jnp.asarray(d3), bmin, bmax, lmax,
                            tmax=None if tmax is None else jnp.asarray(tmax))
        for name, a, b in zip(("meta", "ids", "nears", "cutoff"), got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        meta, ids, nears = got[0], got[1], got[2]
        zeros = int((nears[0] == 0.0).sum())
        assert zeros >= 3 and not bool(torch.signbit(nears).any())
        tied = ids[0, :zeros]
        assert torch.equal(tied, torch.sort(tied).values)    # id order
        assert bool(meta[:, 1].any()) == (lmax == 4)


def test_sweep_with_no_boxes():
    """K = 0 (a direct call; ``cull`` rejects it): every row's count is
    zero and the keys and hit mask have no column, on the CPU as on a card
    (where nothing is launched: tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(3)
    o3 = torch.from_numpy(rng.uniform(-1, 1, (3, 5, 128)).astype(np.float32))
    d3 = torch.from_numpy(rng.normal(size=(3, 5, 128)).astype(np.float32))
    none = torch.zeros((0, 3))
    for tmax in (None, torch.ones(5, 128)):
        count, key, hit = cc.cull_sweep(o3, d3, none, none, tmax, hits=True)
        assert count.dtype == torch.int32 and torch.equal(count, torch.zeros(5, dtype=torch.int32))
        assert key.shape == hit.shape == (5, 0)
