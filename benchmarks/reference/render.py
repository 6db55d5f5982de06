"""The plain path tracer of the reference.

The estimator of the renders the benchmark times, written out lane by lane
from the scene tables of ``reference/scene.py``, the streams of
``reference/threefry.py`` and the queries of ``reference/accel.py``; it
imports nothing of the program.  Per path vertex k = 1..depth:

- a miss adds throughput x background and ends the path;
- emission counts on the primary hit only, weighted by max(0, wo . n);
- next-event estimation picks a light uniformly, a point on it with
  b0 = u1, b1 = u2 (1 - b0), and adds ke x max(0, cos_i cos_l) / (1 + d^2)
  x area x n_lights x kd / pi unless a shadow ray from hit + 1e-3 n, with
  tmax = d and the light's own triangle excluded, is blocked;
- the path goes on along a cosine sample about the stored normal while
  u_rr <= max(kd) / pi (Russian roulette), its throughput times
  f |cos| / (pdf max(kd) / pi), until depth k;
- kd is the nearest texel (coordinates wrapped, an integral coordinate above
  0 mapping to 1) where the triangle is textured, its own kd elsewhere.

Vectors are (3, R): one column a lane.  Each formula keeps the operand order
of the estimator as written above (its dot products summed x, y, z), so that
float32 lanes agree with any implementation that evaluates it op by op.
Everything float runs in the scene's dtype: float32, or bfloat16 for the
control.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmarks.reference import threefry as tf

M_PI = float(np.float32(np.pi))
M_1_PI = float(np.float32(1.0 / np.pi))
EPS_OFFSET = float(np.float32(1.0e-3))


def camera_basis(eye, center, up, yview, xres, yres):
    """(left_upper, dx, dy) float32 (3,) vectors (``rayTracer.cpp:41-49``):
    the upper-left ray direction and the steps of one pixel."""
    eye, center, up = (np.asarray(x, np.float32) for x in (eye, center, up))
    z = np.float32(1.0)
    y = z * 0.5 * np.float32(yview)
    x = y * (np.float32(xres) / np.float32(yres))
    f = (center - eye) / np.linalg.norm(center - eye)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    dy = (1.0 / yres) * (-2.0 * y) * u
    dx = (1.0 / xres) * (2.0 * x) * s
    left_upper = -x * s + y * u + z * f
    return left_upper, dx, dy


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def normalize(v):
    return v * torch.rsqrt(torch.clamp_min(dot(v, v), 1e-20))[None]


def norm(v):
    return torch.sqrt(torch.clamp_min(dot(v, v), 1e-20))


def where3(mask, a, b):
    return torch.where(mask[None], a, b)


def _safe(x):
    return torch.where(x == 0.0, 1.0, x)


def cosine_sample(n, u, v):
    """Cosine-weighted direction about the raw normal n (the concentric
    disk map, ``brdf.cpp:18-79``): (wi, pdf = max(0, n . wi) / pi)."""
    sx, sy = 2.0 * u - 1.0, 2.0 * v - 1.0
    zero = (sx == 0.0) & (sy == 0.0)
    r1, t1 = sx, torch.where(sy > 0.0, sy / _safe(sx), 8.0 + sy / _safe(sx))
    r2, t2 = sy, 2.0 - sx / _safe(sy)
    r3, t3 = -sx, 4.0 - sy / _safe(-sx)
    r4, t4 = -sy, 6.0 + sx / _safe(-sy)
    in12, in1, in3 = sx >= -sy, sx > sy, sx <= sy
    r = torch.where(in12, torch.where(in1, r1, r2), torch.where(in3, r3, r4))
    th = torch.where(in12, torch.where(in1, t1, t2), torch.where(in3, t3, t4)) * (M_PI / 4.0)
    dx = torch.where(zero, 0.0, r * torch.cos(th))
    dy = torch.where(zero, 0.0, r * torch.sin(th))
    dz = torch.sqrt(torch.clamp_min(1.0 - dx * dx - dy * dy, 0.0))
    cond = n[0].abs() < n[1].abs()
    perp = torch.stack([torch.where(cond, 0.0, -n[2]), torch.where(cond, -n[2], 0.0),
                        torch.where(cond, n[1], n[0])])
    tangent = normalize(perp)
    bitangent = normalize(cross(tangent, n))
    wi = normalize(dx[None] * tangent + dy[None] * bitangent + dz[None] * n)
    return wi, torch.clamp_min(dot(n, wi), 0.0) * M_1_PI


def _wrap(c):
    f = c - torch.floor(c)
    return torch.where((f == 0.0) & (c > 0.0), 1.0, f)


def albedo(scene, tex, uvp, kd):
    """Nearest texel where ``tex`` >= 0, ``kd`` elsewhere; (3, R)."""
    if scene.tex_data.shape[0] <= 1:
        return kd
    safe = torch.clamp_min(tex, 0)
    tw, th, off = scene.tex_width[safe], scene.tex_height[safe], scene.tex_offset[safe]
    x = torch.minimum((_wrap(uvp[0]) * tw).to(torch.int64), tw - 1)
    y = torch.minimum((_wrap(uvp[1]) * th).to(torch.int64), th - 1)
    texel = scene.tex_data.T[:, off + y * tw + x]
    return where3(tex >= 0, texel, kd)


def _fetch(table, idx, hit):
    """Rows of a (T, C) table at idx as (C, R), zero where not hit."""
    return torch.where(hit[:, None], table[idx], 0.0).T


def trace(scene, groups, cam, pixel_idx, px, py, sample, seed, depth, background):
    """Radiance (3, R) of the lanes (global pixel index, its column and row,
    sample index) at the camera ``cam = (eye, left_upper, dx, dy)``."""
    dt = scene.v0.dtype
    dev = scene.v0.device
    R = pixel_idx.numel()
    eye, left_upper, cdx, cdy = (torch.as_tensor(np.asarray(c, np.float32), device=dev).to(dt)
                                 for c in cam)
    k0, k1 = tf.base_key(seed, pixel_idx, sample)
    jx, jy = tf.jitter(k0, k1)
    cx = (px.to(torch.float32) + jx).to(dt)[None]
    cy = (py.to(torch.float32) + jy).to(dt)[None]
    direction = left_upper[:, None] + cx * cdx[:, None] + cy * cdy[:, None]
    origin = eye[:, None].expand(3, R)
    bg = torch.as_tensor(np.asarray(background, np.float32), device=dev).to(dt)[:, None]
    wmin, wmax = scene.world_min, scene.world_max
    zero = torch.zeros(R, dtype=dt, device=dev)
    park_o = torch.stack([(wmax[0] + (wmax[0] - wmin[0]) + 1.0).expand(R), zero, zero])
    park_d = torch.stack([torch.ones_like(zero), zero, zero])
    throughput = torch.ones((3, R), dtype=dt, device=dev)
    radiance = torch.zeros((3, R), dtype=dt, device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    nl = scene.n_lights

    for k in range(1, depth + 1):
        live = torch.nonzero(active).reshape(-1)
        hit = torch.zeros(R, dtype=torch.bool, device=dev)
        tid = torch.zeros(R, dtype=torch.int64, device=dev)
        bu = torch.zeros(R, dtype=dt, device=dev)
        bv = torch.zeros(R, dtype=dt, device=dev)
        if live.numel():
            h, _, i, u, v = groups.closest(origin[:, live].T.contiguous(),
                                           direction[:, live].T.contiguous())
            hit[live], tid[live], bu[live], bv[live] = h, i, u.detach(), v.detach()
        hit = hit & active
        v0 = _fetch(scene.v0, tid, hit)
        point = ((1.0 - bu - bv)[None] * v0 + bu[None] * (v0 + _fetch(scene.e1, tid, hit))
                 + bv[None] * (v0 + _fetch(scene.e2, tid, hit)))
        normal = _fetch(scene.normal, tid, hit)
        w = 1.0 - bu - bv
        uvp = (_fetch(scene.uv0, tid, hit) * w[None] + _fetch(scene.uv1, tid, hit) * bu[None]
               + _fetch(scene.uv2, tid, hit) * bv[None])
        kd = albedo(scene, torch.where(hit, scene.tex_id[tid], 0), uvp, _fetch(scene.kd, tid, hit))
        radiance = radiance + where3(active & ~hit, throughput * bg, 0.0)
        nee_origin = where3(hit, point + EPS_OFFSET * normal, park_o)
        wo = normalize(origin - point)
        f_brdf = kd * M_1_PI
        if k == 1:
            emitted = where3(hit & scene.emissive[tid], _fetch(scene.ke, tid, hit), 0.0)
            direct = torch.clamp_min(dot(wo, normal), 0.0)[None] * emitted
        else:
            direct = torch.zeros((3, R), dtype=dt, device=dev)
        un = tf.bounce_uniforms(k0, k1, k).to(dt)
        if nl > 0:
            li = torch.clamp_max((un[tf.DIM_LIGHT_SEL] * nl).to(torch.int32), nl - 1).long()
            ltid = scene.light_ids[li]
            lv0, lv1, lv2 = scene.v0[ltid].T, scene.v1[ltid].T, scene.v2[ltid].T
            lnormal, lke, larea = scene.normal[ltid].T, scene.ke[ltid].T, scene.light_areas[li]
            b0 = un[tf.DIM_LIGHT_U]
            b1 = un[tf.DIM_LIGHT_V] * (1.0 - b0)
            lpoint = b0[None] * lv0 + b1[None] * lv1 + (1.0 - b0 - b1)[None] * lv2
            to_light = lpoint - point
            dist = norm(to_light)
            wl = normalize(to_light)
            occluded = torch.zeros(R, dtype=torch.bool, device=dev)
            lit = torch.nonzero(hit).reshape(-1)
            if lit.numel():
                occluded[lit] = groups.occluded(
                    nee_origin[:, lit].T.contiguous(), wl[:, lit].detach().T.contiguous(),
                    dist[lit].detach(), ltid[lit])
            geometric = torch.clamp_min(dot(normal, wl) * dot(-wl, lnormal) / (1.0 + dist * dist), 0.0)
            nee = lke * (geometric * larea * nl)[None] * f_brdf
            direct = direct + where3(~occluded, nee, 0.0)
        radiance = radiance + where3(hit, throughput * direct, 0.0)
        wi, pdf = cosine_sample(normal, un[tf.DIM_BSDF_U], un[tf.DIM_BSDF_V])
        kmax = f_brdf.amax(dim=0)
        survive = (pdf > 0.0) & (un[tf.DIM_RR] <= kmax)
        cosine = dot(normal, wi).abs()
        scale = f_brdf * (cosine / torch.where(pdf > 0.0, pdf * kmax, 1.0))[None]
        new_active = hit & survive & (k < depth)
        throughput = where3(new_active, throughput * scale, throughput)
        origin = where3(new_active, point + EPS_OFFSET * normal, park_o).detach()
        direction = where3(new_active, wi, park_d).detach()
        active = new_active
    return radiance


def sample_radiance(scene, groups, cam, xres, pixels, n_samples, seed, depth, background,
                    lanes=1 << 18):
    """(P, n_samples, 3) float32 radiance of samples 0 .. n_samples - 1 of
    each of the P global pixel indices, ``lanes`` lanes a trace."""
    dev = scene.v0.device
    pix = torch.as_tensor(np.asarray(pixels, np.int64), device=dev)
    pi = pix.repeat_interleave(n_samples)
    s = torch.arange(n_samples, device=dev).repeat(pix.numel())
    out = [trace(scene, groups, cam, pi[b:b + lanes], pi[b:b + lanes] % xres,
                 pi[b:b + lanes] // xres, s[b:b + lanes], seed, depth, background).float().T
           for b in range(0, pi.numel(), lanes)]
    return torch.cat(out).reshape(pix.numel(), n_samples, 3)


def accumulate(samples, spp):
    """The progressive image after each pass of ``spp`` samples, as numpy
    float32 (P, 3): a pass's image is its samples summed in order, times
    1/spp, times spp, times 1/spp; the running image after L passes is
    (image_{L-1} (L - 1) + pass_L) / L in float32."""
    P, S, _ = samples.shape
    passes = S // spp
    x = samples[:, :passes * spp].reshape(P, passes, spp, 3)
    total = x[:, :, 0]
    for j in range(1, spp):
        total = total + x[:, :, j]
    imgs = (((total * (1.0 / spp)) * spp) * (1.0 / spp)).cpu().numpy()
    acc = np.zeros((P, 3), np.float32)
    for layer in range(1, passes + 1):
        acc = (acc * (layer - 1) + imgs[:, layer - 1]) / layer
    return acc
