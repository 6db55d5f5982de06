"""Exact ray queries for the reference: Moller-Trumbore over every triangle
of every box a ray meets, boxes taken near to far.

The triangles are grouped by the Morton order of their centroids into groups
of ``GROUP`` (the reference's own grouping, not the port's clusters); each
group's box is padded so that it holds every hit the test below can report.
A ray tests its boxes in order of entry, ``WIDTH`` at a time, and stops once
its nearest hit lies before the next box's entry: no later box can hold a
nearer one.  Every triangle of every box a ray tests is tested, so the answer
is brute force's: the closest hit is the least (t, triangle id), and a shadow
ray is occluded by any triangle other than the excluded one with t < tmax.
The test is the reference Moller-Trumbore (``src/kdtree.cpp:219-246``):
|a| < FLT_EPSILON misses, u in [0, 1], v >= 0, u + v <= 1, t >= 0.
"""

from __future__ import annotations

import numpy as np
import torch

GROUP = 256          # triangles a group
WIDTH = 2            # boxes a ray tests a round
RAY_BLOCK = 1 << 16  # rays whose boxes are sorted together
FLT_EPS = float(np.finfo(np.float32).eps)
NO_HIT = torch.iinfo(torch.int64).max


def _part1by2(x):
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def moller_trumbore(o, d, v0, e1, e2):
    """Broadcast Moller-Trumbore: o, d (..., 3) rays, v0/e1/e2 (..., 3)
    triangles -> (ok, t, u, v)."""
    def comp(x):
        return x[..., 0], x[..., 1], x[..., 2]
    ox, oy, oz = comp(o)
    dx, dy, dz = comp(d)
    v0x, v0y, v0z = comp(v0)
    e1x, e1y, e1z = comp(e1)
    e2x, e2y, e2z = comp(e2)
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


class Groups:
    """Triangle groups with padded boxes, built on the host from the
    float32 corners ``(T, 3, 3)``."""

    def __init__(self, scene, group: int = GROUP):
        corners = scene.corners
        T = corners.shape[0]
        dev = scene.v0.device
        cen = corners.mean(axis=1)
        lo, hi = cen.min(axis=0), cen.max(axis=0)
        q = np.clip((cen - lo) / np.maximum(hi - lo, 1e-12) * 1023.0, 0, 1023).astype(np.int64)
        code = _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)
        order = np.argsort(code, kind="stable")
        G = -(-T // group)
        members = np.full(G * group, -1, np.int64)
        members[:T] = order
        members = members.reshape(G, group)
        members = np.sort(np.where(members < 0, T, members), axis=1)   # ids ascending, pads last
        members = np.where(members == T, -1, members)
        pts = corners[np.clip(members, 0, T - 1)]             # (G, S, 3, 3)
        valid = (members >= 0)[:, :, None, None]
        big = np.float32(3.0e38)
        bmin = np.where(valid, pts, big).min(axis=(1, 2))
        bmax = np.where(valid, pts, -big).max(axis=(1, 2))
        ext = float(np.max(corners.max(axis=(0, 1)) - corners.min(axis=(0, 1))))
        pad = np.float32(1.0e-5 * ext + 1.0e-6)
        self.bmin = torch.from_numpy(bmin - pad).to(dev)
        self.bmax = torch.from_numpy(bmax + pad).to(dev)
        self.members = torch.from_numpy(members).to(dev)
        self.scene = scene

    def _entries(self, o, d, tmax):
        """(R, G) entry distance of each box a ray meets (inf where it
        misses), in float32."""
        o, d = o.float(), d.float()
        near = far = None
        for a in range(3):
            inv = 1.0 / d[:, a:a + 1]
            t0 = (self.bmin[None, :, a] - o[:, a:a + 1]) * inv
            t1 = (self.bmax[None, :, a] - o[:, a:a + 1]) * inv
            inside = (o[:, a:a + 1] >= self.bmin[None, :, a]) & (o[:, a:a + 1] <= self.bmax[None, :, a])
            flat = d[:, a:a + 1] == 0.0
            lo = torch.where(flat, torch.where(inside, -np.inf, np.inf), torch.minimum(t0, t1))
            hi = torch.where(flat, torch.where(inside, np.inf, -np.inf), torch.maximum(t0, t1))
            near = lo if near is None else torch.maximum(near, lo)
            far = hi if far is None else torch.minimum(far, hi)
        near = torch.clamp_min(near, 0.0)
        meet = far >= near
        if tmax is not None:
            meet = meet & (near <= tmax.float()[:, None])
        return torch.where(meet, near, np.inf)

    def _walk(self, o, d, tmax, excl):
        """Closest (tmax None): (R,) int64 keys (t bits << 32 | id), NO_HIT
        where none; occlusion: (R,) bool."""
        s = self.scene
        R = o.shape[0]
        closest = tmax is None
        out = (torch.full((R,), NO_HIT, dtype=torch.int64, device=o.device) if closest
               else torch.zeros(R, dtype=torch.bool, device=o.device))
        for base in range(0, R, RAY_BLOCK):
            rows = torch.arange(base, min(R, base + RAY_BLOCK), device=o.device)
            ent = self._entries(o[rows], d[rows], None if closest else tmax[rows])
            ent, order = torch.sort(ent, dim=1)
            n_meet = torch.isfinite(ent).sum(dim=1)
            G = ent.shape[1]
            pos = torch.zeros(rows.numel(), dtype=torch.int64, device=o.device)
            live = torch.nonzero(n_meet > 0).reshape(-1)
            while live.numel():
                r = rows[live]
                cols = (pos[live, None] + torch.arange(WIDTH, device=o.device)[None]).clamp_max(G - 1)
                taken = cols < n_meet[live, None]
                tri = self.members[order[live[:, None], cols]]           # (n, W, S)
                tri = torch.where(taken[:, :, None], tri, -1).reshape(live.numel(), -1)
                safe = tri.clamp_min(0)
                ok, t, _, _ = moller_trumbore(o[r][:, None], d[r][:, None], s.v0[safe], s.e1[safe], s.e2[safe])
                ok = ok & (tri >= 0)
                t = t.float()
                if closest:
                    key = (t.view(torch.int32).to(torch.int64) << 32) | safe
                    key = torch.where(ok, key, NO_HIT).amin(dim=1)
                    out[r] = torch.minimum(out[r], key)
                    best = (out[r] >> 32).to(torch.int32).view(torch.float32)
                    best = torch.where(out[r] == NO_HIT, np.inf, best)
                else:
                    blocked = (ok & (t < tmax[r, None].float()) & (safe != excl[r, None])).any(dim=1)
                    out[r] = out[r] | blocked
                pos[live] += WIDTH
                nxt = pos[live].clamp_max(G - 1)
                more = pos[live] < n_meet[live]
                if closest:
                    more = more & (best >= ent[live, nxt])
                else:
                    more = more & ~out[r]
                live = live[more]
        return out

    def closest(self, o, d):
        """(hit, t, tid, u, v) of rays o, d (R, 3): the least (t, id) hit;
        t, u and v in the scene's dtype, tid 0 where nothing is hit."""
        key = self._walk(o, d, None, None)
        hit = key != NO_HIT
        tid = torch.where(hit, key & 0xFFFFFFFF, 0)
        s = self.scene
        _, t, u, v = moller_trumbore(o, d, s.v0[tid], s.e1[tid], s.e2[tid])
        return hit, t, tid, u, v

    def occluded(self, o, d, tmax, excl):
        return self._walk(o, d, tmax, excl)
