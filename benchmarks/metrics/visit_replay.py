"""The walk of the cluster visits K4/K5 replayed lane by lane, frozen for the
benchmark (a copy of the port's ``ops/cluster_cuda._visit_walk`` and its
Moller-Trumbore as they stood when the benchmark was defined).

Each lane walks its row's list from the cull K3 on its own: it visits the
listed clusters in order while its own vote holds (closest: its best t is at
least the next cluster's entry; occlusion: it is still open and its tmax
reaches the entry), then, where the row's list overflowed, sweeps all K
clusters in id order while it reaches the cutoff.  ``tests`` counts, per
lane, the (lane, triangle) tests its walk needs: for a closest query every
triangle of every block it visits; for occlusion each triangle up to and
including its first blocker.  These are the tests any walker of the same
lists needs, whatever rule makes a warp exit.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmarks.metrics import bounds

LANE = 128
BIG = 3.0e38
GEO_ROWS = 10
FLT_EPS = float(np.finfo(np.float32).eps)
_PLAIN_PAIRS = 1 << 22


def mt_core(o, d, v0, e1, e2):
    """Moller-Trumbore over broadcastable components: (ok, t, u, v)."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    a = e1x * px + e1y * py + e1z * pz
    nonpar = a.abs() >= FLT_EPS
    f = 1.0 / torch.where(nonpar, a, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = f * (sx * px + sy * py + sz * pz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = nonpar & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    return ok, t, u, v


def lane_walk(meta, ids, nears, cutoff, o3, d3, packed, tmax=None, excl=None):
    """(visits (B0, 128) int32, tests (B0, 128) int64) of each lane walking
    on its own (the copied walk's groups of ``lanes`` lanes, at one lane).
    ``tmax``/``excl`` None means a closest query, else occlusion."""
    lanes = 1
    B0 = o3.shape[1]
    G = LANE // lanes
    U = B0 * G
    K, _, M = packed.shape
    Le = ids.shape[1]
    dev = o3.device
    row = torch.arange(U, device=dev) // G
    trip = meta[:, 0].long()[row]
    cut = cutoff[:, 0][row, None]
    o, d = o3.reshape(3, U, lanes), d3.reshape(3, U, lanes)
    if tmax is None:
        best = torch.full((U, lanes), BIG, dtype=torch.float32, device=dev)

        def wants(units, bound):
            return best[units] >= bound
    else:
        tm, ex = tmax.reshape(U, lanes), excl.reshape(U, lanes)
        occ = torch.zeros((U, lanes), dtype=torch.bool, device=dev)

        def wants(units, bound):
            return ~occ[units] & (tm[units] >= bound)
    visits = torch.zeros(U, dtype=torch.int64, device=dev)
    pos = torch.zeros(U, dtype=torch.int64, device=dev)
    sweeping = torch.zeros(U, dtype=torch.bool, device=dev)
    live = torch.ones(U, dtype=torch.bool, device=dev)
    tests = torch.zeros(U, dtype=torch.int64, device=dev)
    tri = torch.arange(M, device=dev)[None, :, None]
    per = max(1, _PLAIN_PAIRS // (M * lanes))
    while True:
        units = torch.nonzero(live).reshape(-1)
        if units.numel() == 0:
            break
        p, r, in2 = pos[units], row[units], sweeping[units]
        near = nears[r, torch.clamp_max(p, Le - 1)][:, None]
        go1 = ~in2 & (p < trip[units]) & wants(units, near).any(dim=1)
        p = torch.where(in2 | go1, p, 0)
        in2 = ~go1
        go = go1 | (in2 & (p < K) & wants(units, cut[units]).any(dim=1))
        sweeping[units] = in2
        live[units] = go
        units, p, go1, r = units[go], p[go], go1[go], r[go]
        pos[units] = p + 1
        visits[units] += 1
        cids = torch.where(go1, ids[r, torch.clamp_max(p, Le - 1)].long(), p)
        for base in range(0, units.numel(), per):
            us = units[base:base + per]
            blk = packed[cids[base:base + per]]                    # (A, 10, M)
            cols = tuple(blk[:, c, :, None] for c in range(9))     # (A, M, 1)
            oid = blk[:, 9].contiguous().view(torch.int32)[:, :, None]
            ok, t, _, _ = mt_core(tuple(o[a, us][:, None] for a in range(3)),
                                  tuple(d[a, us][:, None] for a in range(3)),
                                  cols[0:3], cols[3:6], cols[6:9])  # (A, M, lanes)
            if tmax is None:
                tests[us] += M * lanes
                hit_t = torch.where(ok & (t < BIG), t, BIG).amin(dim=1)
                best[us] = torch.minimum(best[us], hit_t)
            else:
                blocking = ok & (t < tm[us][:, None]) & (oid != ex[us][:, None])
                first = torch.where(blocking, tri, M).amin(dim=1)   # (A, lanes)
                was = occ[us]
                tests[us] += torch.where(was, 0, torch.clamp_max(first + 1, M)).sum(1)
                occ[us] = was | (first < M)
    return visits.to(torch.int32).reshape(B0, G), tests.reshape(B0, G)


@contextlib.contextmanager
def recording():
    """Record each K4-K7 launch of the block (its lists, rays, blocks and,
    for a closest query, the hit ids), by wrapping the port's two visit
    launchers; yields the list of launches."""
    from chiaroscuro_tpu_torch.ops import cluster_cuda as cc

    calls = []
    closest0, any0 = cc._closest_visit, cc._any_visit

    def closest(kernel, meta, ids, nears, cutoff, o3, d3, packed, attrs, visits):
        out = closest0(kernel, meta, ids, nears, cutoff, o3, d3, packed, attrs, visits)
        calls.append({"closest": True, "lists": (meta, ids, nears, cutoff), "o3": o3,
                      "d3": d3, "packed": packed, "t": out[0], "tid": out[1]})
        return out

    def any_(kernel, meta, ids, nears, cutoff, o3, d3, tmax, excl, packed, visits):
        out = any0(kernel, meta, ids, nears, cutoff, o3, d3, tmax, excl, packed, visits)
        calls.append({"closest": False, "lists": (meta, ids, nears, cutoff), "o3": o3,
                      "d3": d3, "packed": packed, "tmax": tmax, "excl": excl})
        return out

    cc._closest_visit, cc._any_visit = closest, any_
    try:
        yield calls
    finally:
        cc._closest_visit, cc._any_visit = closest0, any0


def launch_bound_s(call) -> float:
    """The bound of one recorded launch with per-lane test counts."""
    meta = call["lists"][0]
    o3, packed = call["o3"].detach(), call["packed"]
    closest = call["closest"]
    with torch.no_grad():
        visits, tests = lane_walk(*call["lists"], o3, call["d3"].detach(), packed,
                                  None if closest else call["tmax"].detach(),
                                  None if closest else call["excl"])
    B0 = o3.shape[1]
    K, _, M = packed.shape
    hit_tris = 0
    if closest:
        hit_tris = int(torch.unique(call["tid"][call["t"] < BIG]).numel())
    nbytes = bounds.visit_bytes(B0, M, K, B0, int(meta[:, 0].sum()), int(visits.sum()),
                                closest, hit_tris)
    return bounds.bound_s(bounds.MT_OPS * int(tests.sum()), nbytes)
