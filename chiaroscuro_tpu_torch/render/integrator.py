"""Wavefront path-tracing integrator (torch port of
``chiaroscuro_tpu/render/integrator.py``).

All rays advance together through a loop over bounce index with an active
mask; terminated lanes stop contributing.  The estimator is the reference's
per-pixel recursion (``src/rayTracer.cpp:76-135``) as masked updates of
(throughput, L), with its semantics kept exactly:

- emission only on *primary* hits, weighted by max(0, dot(wo, n))
  (``rayTracer.cpp:85``) — secondary light hits contribute only via NEE;
- NEE geometric term max(0, cos_i * cos_l) / (1 + d^2) — the reference's
  nonstandard falloff (``rayTracer.cpp:106``);
- NEE weight = area * n_lights (uniform light pick; ``rayTracer.cpp:108``),
  light point from v0 ~ U(0,1), v1 ~ U(0, 1-v0) (``rayTracer.cpp:96-97``);
- shadow ray from hit + 1e-3 * n with tmax = distance, excluding the sampled
  light triangle id (``rayTracer.cpp:104``, ``kdtree.cpp:322-331``);
- Russian roulette on Kmax = max(Kd)/pi, survival iff u <= Kmax,
  throughput *= f * |cos| / (pdf * Kmax) (``rayTracer.cpp:124-131``);
- depth cap k == K stops after direct lighting (``rayTracer.cpp:113-116``);
- miss at any depth contributes throughput * background
  (``rayTracer.cpp:134``);
- flat per-triangle normal = mean of vertex normals, used raw
  (``kdtree.cpp:58-60``).

Intersectors are injected (``closest_fn``, ``any_fn``): planar-native ones
(the dense and cluster kernels, ``.planar_fn``) get the wavefront as is, the
dense ones with ``live`` row hints; row-major ones (the brute oracle) get
explicit conversions.  Bounce compaction and the cluster path's spatial ray
sort (``compact=True``) are pure lane permutations.

While a torch.profiler runs, each bounce opens the span ``render.bounce``
with its children ``render.compact`` (the compaction sort and gather),
``render.closest`` (the closest query and the hit's attributes) and
``render.shadow`` (each shadow query; ``utils/profiling.span``); shading is
the bounce's self time.

The Phong extension (``scene.has_specular``, off by default: the
reference's two-type system) shades ``BRDF_PHONG`` lanes with Kd/pi + Ks
(ns+2)/(2pi) cos^ns about the mirror direction, in NEE and point-light
shading alike, and extends their paths by a one-sample mixture of the
cosine lobe and the Phong lobe, picked on ``prng.DIM_LOBE`` with
probability maxKs / (maxKd + maxKs), survival clamped to
[0.05, 0.95] of maxKd + maxKs, lobes below the surface absorbed.  Lanes of
other types reduce exactly to the reference branch.

Autograd: radiance is differentiable with respect to the scene's float
fields (kd, ke, ks, shininess, vertex positions, normals, texcoords,
texels, light areas) through the closest-hit queries'
``autograd.Function``s and plain torch ops.  As in the JAX package, hit
ids, light picks, Russian roulette and occlusion are discrete and carry no
gradient, and the world bounds (only parking and the sort keys read them)
are detached where JAX stops their gradient.  Every write into a tensor is
out of place or lands in an integer or bool tensor (the per-bounce counts,
the shadow scatter), and no ``.item()`` steers the math.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from chiaroscuro_tpu_torch.accel.bvh import check_no_vertex_grad
from chiaroscuro_tpu_torch.geometry import planar as P
from chiaroscuro_tpu_torch.ops.intersect_cuda import onehot_fetch
from chiaroscuro_tpu_torch.sampling import prng
from chiaroscuro_tpu_torch.sampling.samplers import (
    M_1_PI,
    phong_pdf_planar,
    reflect_planar,
    sample_phong_lobe_planar,
    sample_wi_diffuse_planar,
)
from chiaroscuro_tpu_torch.scene.scene_arrays import (
    BRDF_EMISSIVE,
    BRDF_PHONG,
    SceneTensors,
)
from chiaroscuro_tpu_torch.utils.profiling import span

EPS_OFFSET = float(np.float32(1.0e-3))  # rayTracer.cpp:104,130

# Bounce-compaction segment width in lanes: live lanes pack to the front of
# each segment between bounces (the JAX package's value, tuned on the TPU).
COMPACT_SEG_LANES = 4096

# Up to this many lights the light row is fetched by a one-hot product
# (ops/intersect_cuda.onehot_fetch), above by a gather (integrator.py:659).
ONEHOT_MAX_LIGHTS = 512

# Per-axis |direction|-share bits in the spatial bounce-sort key: 2 -> 4x4
# angular bins inside each octant (the JAX package's measured winner on the
# 480k atrium).  Ordering-only metadata; _spatial_key checks that the key
# stays below 2^31.
_DIR_BITS = 2


def _wrap(c):
    """Texture-coordinate wrap (``mesh.cpp:21-35``): fractional part, except
    exactly-integral coords > 0 map to 1.0."""
    f = c - torch.floor(c)
    return torch.where((f == 0.0) & (c > 0.0), 1.0, f)


def _interp_uv(scene: SceneTensors, tid, u, v):
    w = 1.0 - u - v
    return (
        scene.uv0[tid] * w[..., None]
        + scene.uv1[tid] * u[..., None]
        + scene.uv2[tid] * v[..., None]
    )


def _atlas_fetch(scene: SceneTensors, tex_id, uv, fallback):
    """Nearest-texel fetch with repeat wrap from the flat atlas, or
    ``fallback`` where ``tex_id < 0`` (row-major: uv (R, 2), fallback (R, 3)).
    Coordinates that wrap to exactly 1.0 clamp to the last texel."""
    if scene.tex_data.shape[0] <= 1:
        return fallback   # untextured scene: only the dummy texel
    safe_id = torch.clamp_min(tex_id, 0).long()
    tw = scene.tex_width[safe_id]
    th = scene.tex_height[safe_id]
    off = scene.tex_offset[safe_id]
    x = torch.minimum((_wrap(uv[..., 0]) * tw).to(torch.int32), tw - 1)
    y = torch.minimum((_wrap(uv[..., 1]) * th).to(torch.int32), th - 1)
    texel = scene.tex_data[(off + y * tw + x).long()]
    return torch.where((tex_id >= 0)[..., None], texel, fallback)


def texture_kd_lookup(scene: SceneTensors, tid, u, v):
    """Diffuse albedo at a hit (``rayTracer.cpp:153-157``)."""
    return _atlas_fetch(
        scene, scene.tex_id[tid], _interp_uv(scene, tid, u, v), scene.kd[tid]
    )


def texture_ks_lookup(scene: SceneTensors, tid, u, v):
    """Specular reflectance at a hit (Phong extension; the reference loads
    specular maps but uses them only in its raster preview,
    ``mesh.cpp:54-62``)."""
    return _atlas_fetch(
        scene, scene.tex_id_ks[tid], _interp_uv(scene, tid, u, v), scene.ks[tid]
    )


def _atlas_fetch_planar(scene: SceneTensors, tex_id, uvp, fallback):
    """Planar :func:`_atlas_fetch`: tex_id (B0, 128), uvp (2, B0, 128),
    fallback (3, B0, 128)."""
    if scene.tex_data.shape[0] <= 1:
        return fallback
    safe_id = torch.clamp_min(tex_id, 0).long()
    tw = scene.tex_width[safe_id]
    th = scene.tex_height[safe_id]
    off = scene.tex_offset[safe_id]
    x = torch.minimum((_wrap(uvp[0]) * tw).to(torch.int32), tw - 1)
    y = torch.minimum((_wrap(uvp[1]) * th).to(torch.int32), th - 1)
    texel = scene.tex_data.T[:, (off + y * tw + x).long()]   # (3, B0, 128)
    return torch.where((tex_id >= 0)[None], texel, fallback)


def _light_table(scene: SceneTensors):
    """(16, L) per-light columns: v0 | v1 | v2 | normal | ke | area."""
    lids = scene.light_ids.long()
    return torch.cat(
        [
            scene.tri_v0[lids],
            scene.tri_v1[lids],
            scene.tri_v2[lids],
            scene.normal[lids],
            scene.ke[lids],
            scene.light_areas[:, None],
        ],
        dim=1,
    ).T.contiguous()


def _part1by2(x):
    """Spread the low 10 bits of int32 x to every 3rd bit (Morton helper)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_cell(origin, wmin, wext):
    """(B0, 128) int32 15-bit Morton cell (5 bits per axis) of planar
    origins inside the world box [wmin, wmin + wext]."""
    morton = torch.zeros(origin.shape[1:], dtype=torch.int32, device=origin.device)
    for a in range(3):
        q = torch.clamp((origin[a] - wmin[a]) / wext[a] * 32.0, 0.0, 31.0)
        morton = morton | (_part1by2(q.to(torch.int32)) << a)
    return morton


def _spatial_key(origin, direction, active, wmin, wext, dir_bits=_DIR_BITS):
    """(B0, 128) int32 bounce-sort key (``integrator.py:328-356`` of the JAX
    package): dead lanes last, then the direction octant, then two
    ``dir_bits``-bit per-axis |direction| shares (an angular bin inside the
    octant), then the origin's Morton cell.  Rays sharing a row after the
    sort share a tight (direction cone, cell) bundle, which keeps the
    cluster cull's per-row box unions small."""
    cone_w = 2 * dir_bits
    if cone_w + 18 > 30:
        raise ValueError(
            f"dir_bits={dir_bits}: the spatial key needs {cone_w + 19} bits, "
            "more than an int32 holds"
        )
    dead = (~active).to(torch.int32)
    octant = (
        (direction[0] < 0).to(torch.int32)
        | ((direction[1] < 0).to(torch.int32) << 1)
        | ((direction[2] < 0).to(torch.int32) << 2)
    )
    s = direction[0].abs() + direction[1].abs() + direction[2].abs() + 1e-9
    nb = float(1 << dir_bits)
    b1 = torch.clamp(direction[0].abs() / s * nb, 0.0, nb - 1.0)
    b2 = torch.clamp(direction[1].abs() / s * nb, 0.0, nb - 1.0)
    cone = (b1.to(torch.int32) << dir_bits) | b2.to(torch.int32)
    return (
        (dead << (cone_w + 18)) | (octant << (cone_w + 15))
        | (cone << 15) | _morton_cell(origin, wmin, wext)
    )


def _f32_bits(x):
    """Flat 32-bit view of an int payload, so it rides a float gather
    bit for bit (int64 words must hold 32-bit values)."""
    return x.reshape(-1).to(torch.int32).view(torch.float32)


def _sorted_any(any_planar, o, d, tmax, excl, li, hit, wmin, wext):
    """Shadow query with lane reordering (``_sorted_any`` of the JAX
    package): sort the wavefront by (shadowless last, light id, origin
    Morton cell), query the sorted rays, scatter the occlusion bits back.

    A pure permutation — per-lane occlusion does not depend on which rows
    the lanes share — so radiance is bitwise that of the unsorted query.
    NEE picks a light per lane, so pixel-order rows mix up to 128 light
    targets and their cull unions cover most of the scene; sorted rows share
    one target and a tight origin bundle.  The light id is clamped at 1023
    in the key (ordering only)."""
    B = hit.shape
    key = (
        ((~hit).to(torch.int32) << 26)
        | (torch.clamp_max(li, 1023).to(torch.int32) << 16)
        | _morton_cell(o, wmin, wext)
    )
    _, sp = torch.sort(key.reshape(-1), stable=True)
    sm = torch.stack([
        o[0].reshape(-1), o[1].reshape(-1), o[2].reshape(-1),
        d[0].reshape(-1), d[1].reshape(-1), d[2].reshape(-1),
        tmax.reshape(-1), _f32_bits(excl),
    ]).detach()[:, sp]                              # one (8, R) gather
    occ_s = any_planar(
        sm[0:3].reshape((3,) + B), sm[3:6].reshape((3,) + B),
        sm[6].reshape(B), sm[7].view(torch.int32).reshape(B),
    )
    occ = torch.empty_like(occ_s.reshape(-1))
    occ[sp] = occ_s.reshape(-1)
    return occ.reshape(B)


def _compact(key, state, n_seg, seg):
    """Stable-sort each of the ``n_seg`` segments of ``seg`` lanes by
    ``key`` and move the (16, R) stacked ``state`` rows with one gather."""
    _, sp = torch.sort(key.reshape(n_seg, seg), dim=1, stable=True)
    base = torch.arange(n_seg, dtype=sp.dtype, device=sp.device)[:, None] * seg
    return state[:, (sp + base).reshape(-1)]


def _row_live(mask):
    """(B0, 128) bool -> (B0, 1) int32: any lane of the row consumed."""
    return mask.any(dim=1, keepdim=True).to(torch.int32)


def trace_paths(
    scene: SceneTensors,
    origins: torch.Tensor,    # (R, 3) ray origins
    dirs: torch.Tensor,       # (R, 3) primary directions (may be unnormalized)
    keys: torch.Tensor,       # (R, 2) per-(pixel,sample) key words (k0, k1)
    depth: int,
    background: torch.Tensor,  # (3,)
    closest_fn,
    any_fn,
):
    """Estimate radiance for R primary rays (row-major wrapper around
    :func:`trace_paths_planar`; keys as ``prng.pixel_sample_keys`` makes
    them).  Returns (R, 3)."""
    R = origins.shape[0]
    pad = (-R) % 128
    if pad:
        # Replicas of ray 0, sliced off at the end.
        origins = torch.cat([origins, origins[:1].expand(pad, 3)])
        dirs = torch.cat([dirs, dirs[:1].expand(pad, 3)])
        keys = torch.cat([keys, keys[:1].expand(pad, 2)])
    B = ((R + pad) // 128, 128)
    radiance = trace_paths_planar(
        scene,
        P.to_planar(origins, B),
        P.to_planar(dirs, B),
        keys[:, 0].reshape(B),
        keys[:, 1].reshape(B),
        depth,
        background,
        closest_fn,
        any_fn,
    )
    return P.to_rows(radiance)[:R]


def trace_paths_planar(
    scene: SceneTensors,
    origins: torch.Tensor,    # (3, B0, 128) planar ray origins
    dirs: torch.Tensor,       # (3, B0, 128) planar primary directions
    k0: torch.Tensor,         # (B0, 128) per-(pixel,sample) key word 0
    k1: torch.Tensor,         # (B0, 128) key word 1
    depth: int,               # scene.k — max path vertices
    background: torch.Tensor,  # (3,)
    closest_fn,
    any_fn,
    with_stats: bool = False,
    compact: bool = False,
):
    """Estimate radiance for a planar wavefront.  Returns (3, B0, 128).

    With ``with_stats=True`` returns ``(radiance, stats)`` where stats is a
    (depth, 2) int64 tensor of per-bounce useful-work counts:
    ``stats[k] = (lanes active at bounce entry, lanes that hit)`` — the
    closest-hit and shadow queries whose results are consumed.  The
    wavefront issues full-width queries regardless; stats/issued is its SIMD
    occupancy.

    ``compact=True`` turns on bounce compaction: at each bounce entry the
    live lanes are stable-sorted to the front of their COMPACT_SEG_LANES
    segment, so dead lanes fill whole rows that cull to trip 0.  Where the
    intersector declares ``prefers_ray_sort`` (the cluster path at K >=
    1024), the sort is instead one global sort on :func:`_spatial_key`, and
    shadow rays go through :func:`_sorted_any`.  The state moves by one
    stable sort of (key, index) and one stacked (16, R) gather, integer
    payloads riding as float bits; radiance is scattered back to pixel
    order at the end.  Every per-lane operation is unchanged, so radiance
    is bitwise that of ``compact=False``.
    """
    B = tuple(k0.shape)
    R_flat = B[0] * B[1]
    dev = origins.device
    n_lights = scene.n_lights
    spatial_sort = compact and bool(getattr(closest_fn, "prefers_ray_sort", False))
    if spatial_sort and n_lights > 1024:
        warnings.warn(
            f"scene has {n_lights} area lights > 1024: the NEE shadow-sort "
            "key clamps light ids at 1024, so shadow rays for lights beyond "
            "that share a sort bucket and the per-light row coherence "
            "degrades (results stay exact).",
            RuntimeWarning, stacklevel=2,
        )
    # One global sort for the spatial key; else segments of
    # COMPACT_SEG_LANES lanes where they tile the wavefront.
    seg = R_flat
    if not spatial_sort and R_flat % COMPACT_SEG_LANES == 0:
        seg = COMPACT_SEG_LANES
    n_seg = R_flat // seg
    # Morton-cell bounds of the spatial key (ordering-only metadata,
    # detached as JAX's integrator.py:305-307 stops their gradient).
    wmin_s = scene.world_min.detach()
    wext_s = torch.clamp_min(scene.world_max.detach() - wmin_s, 1e-6)
    bg = background[:, None, None]  # (3, 1, 1)
    textured = scene.tex_data.shape[0] > 1
    closest_planar = getattr(closest_fn, "planar_fn", None)
    any_planar = getattr(any_fn, "planar_fn", None)
    accepts_live = getattr(closest_fn, "accepts_live", False)
    if closest_planar is None and getattr(closest_fn, "bvh", None) is not None:
        # A BVH pair built once may be handed a scene whose vertices
        # require grad: its hits carry none (accel/bvh.py).
        check_no_vertex_grad(scene)
    if n_lights > 0:
        light_table = _light_table(scene)

    # Dead-lane parking: an origin beyond every scene box along +x, pointing
    # +x.  Used for non-hit lanes' shadow rays and terminated lanes' bounce
    # rays; every radiance/throughput update is masked on `active`/`hit`, so
    # intersector outputs for parked lanes are never consumed (bounds
    # detached, as integrator.py:614-615 of the JAX package).
    wmax, wmin = scene.world_max.detach(), scene.world_min.detach()
    park_x = wmax[0] + (wmax[0] - wmin[0]) + 1.0
    zero = torch.zeros(B, dtype=torch.float32, device=dev)
    park_o = torch.stack([park_x.expand(B), zero, zero])
    park_d = torch.stack([torch.ones_like(zero), zero, zero])

    def r2(x):  # per-ray scalar -> (B0, 128)
        return x.reshape(B)

    origin, direction = origins, dirs
    throughput = torch.ones((3,) + B, dtype=torch.float32, device=dev)
    radiance = torch.zeros((3,) + B, dtype=torch.float32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    stats = torch.zeros((depth, 2), dtype=torch.int64, device=dev)
    perm = torch.arange(R_flat, dtype=torch.int32, device=dev).reshape(B)

    for k in range(1, depth + 1):
        with span("render.bounce"):
            if compact:
                with span("render.compact"):
                    if spatial_sort:
                        key = _spatial_key(
                            origin, direction, active, wmin_s, wext_s
                        )
                    else:
                        key = (~active).to(torch.int32)
                    sm = _compact(key, torch.stack([
                        origin[0].reshape(-1), origin[1].reshape(-1),
                        origin[2].reshape(-1),
                        direction[0].reshape(-1), direction[1].reshape(-1),
                        direction[2].reshape(-1),
                        throughput[0].reshape(-1), throughput[1].reshape(-1),
                        throughput[2].reshape(-1),
                        radiance[0].reshape(-1), radiance[1].reshape(-1),
                        radiance[2].reshape(-1),
                        active.to(torch.float32).reshape(-1),     # exact 0/1
                        _f32_bits(k0), _f32_bits(k1), _f32_bits(perm),
                    ]), n_seg, seg).reshape((16,) + B)
                    origin, direction = sm[0:3], sm[3:6]
                    throughput, radiance = sm[6:9], sm[9:12]
                    active = sm[12] > 0.5
                    # Keys are uint32 words in int64: undo the int32 wrap.
                    k0 = sm[13].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                    k1 = sm[14].view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                    perm = sm[15].view(torch.int32)

            # Closest hit + hit resolution (rayTracer.cpp:148-166).
            with span("render.closest"):
                if closest_planar is not None:
                    if accepts_live:
                        res = closest_planar(
                            origin, direction, live=_row_live(active)
                        )
                    else:
                        res = closest_planar(origin, direction)
                    hit = res.hit & active
                    bu, bv = res.u, res.v
                    A = res.attrs
                    # The reference's barycentric form (rayTracer.cpp:150-151),
                    # as on the row-major path, not v0 + u*e1 + v*e2: forming
                    # 1-u-v before scaling is better conditioned, so op-by-op
                    # rounding lands where XLA's FMA evaluation of either form
                    # does.  Near a wall's edge the side a hit lands on decides
                    # whether its bounce re-hits the wall (Cornell's default
                    # camera sits on such an edge).  v0 + e1 reproduces v1
                    # exactly where v1 - v0 was exact.
                    v0 = A["v0"]
                    point = (
                        P.pscale(1.0 - bu - bv, v0)
                        + P.pscale(bu, v0 + A["e1"])
                        + P.pscale(bv, v0 + A["e2"])
                    )
                    normal = A["normal"]
                    ke_hit = A["ke"]
                    btype = A["btype"]
                    if textured:
                        uvp = (
                            A["uv0"] * (1.0 - bu - bv)[None]
                            + A["uv1"] * bu[None]
                            + A["uv2"] * bv[None]
                        )
                        kd = _atlas_fetch_planar(
                            scene, A["texid"], uvp, A["kd"]
                        )
                    else:
                        kd = A["kd"]
                    if scene.has_specular:
                        ks = (
                            _atlas_fetch_planar(
                                scene, A["texid_ks"], uvp, A["ks"]
                            )
                            if textured
                            else A["ks"]
                        )
                        ns = A["ns"]
                else:
                    res = closest_fn(P.to_rows(origin), P.to_rows(direction))
                    tid = res.tid.long()
                    hit = r2(res.hit) & active
                    u_, v_ = res.u, res.v
                    # The planar path's form, v0 + e1 for v1: the same bits
                    # where v1 - v0 is exact, and the reference's elsewhere.
                    v0 = scene.tri_v0[tid]
                    point = P.to_planar(
                        v0 * (1.0 - u_ - v_)[:, None]
                        + (v0 + (scene.tri_v1[tid] - v0)) * u_[:, None]
                        + (v0 + (scene.tri_v2[tid] - v0)) * v_[:, None],
                        B,
                    )
                    normal = P.to_planar(scene.normal[tid], B)
                    kd = P.to_planar(texture_kd_lookup(scene, tid, u_, v_), B)
                    ke_hit = P.to_planar(scene.ke[tid], B)
                    btype = r2(scene.brdf_type[tid])
                    if scene.has_specular:
                        ks = P.to_planar(
                            texture_ks_lookup(scene, tid, u_, v_), B
                        )
                        ns = r2(scene.shininess[tid])

            # Miss -> background, terminate (rayTracer.cpp:134).
            radiance = radiance + P.pwhere(active & ~hit, throughput * bg, 0.0)

            nee_origin = P.pwhere(hit, point + EPS_OFFSET * normal, park_o)
            wo = P.pnormalize(origin - point)
            f_brdf = kd * M_1_PI  # Diffuse::f (brdf.cpp:70)

            if scene.has_specular:
                # Phong extension state (never active in reference-parity
                # mode).
                is_phong = btype == BRDF_PHONG
                n_unit = P.pnormalize(normal)
                wr = reflect_planar(wo, n_unit)
                spec_norm = (ns + 2.0) * (0.5 * M_1_PI)

                def phong_f(wi_dir):
                    """Full BRDF f(wi, wo) = Kd/pi + Ks (ns+2)/2pi cos^ns."""
                    cos_r = torch.clamp_min(P.pdot(wr, wi_dir), 0.0)
                    spec = ks * (spec_norm * torch.pow(cos_r, ns))[None]
                    return f_brdf + P.pwhere(is_phong, spec, 0.0)

            if k == 1:
                emitted = P.pwhere(btype == BRDF_EMISSIVE, ke_hit, 0.0)
                direct = P.pscale(
                    torch.clamp_min(P.pdot(wo, normal), 0.0), emitted
                )
            else:
                direct = torch.zeros((3,) + B, dtype=torch.float32, device=dev)

            # (N_BOUNCE_DIMS, B0, 128)
            un = prng.bounce_uniforms_planar(k0, k1, k)
            shadow_live = _row_live(hit)

            def occluded_by(o, d, tmax, excl, li=None):
                with span("render.shadow"):
                    if (spatial_sort and li is not None
                            and any_planar is not None):
                        return _sorted_any(any_planar, o, d, tmax, excl, li,
                                           hit, wmin_s, wext_s)
                    if any_planar is None:
                        return r2(any_fn(
                            P.to_rows(o), P.to_rows(d), tmax.reshape(-1),
                            excl.reshape(-1),
                        ))
                    if accepts_live:
                        return any_planar(o, d, tmax, excl, live=shadow_live)
                    return any_planar(o, d, tmax, excl)

            if n_lights > 0:
                li = torch.clamp_max(
                    (un[prng.DIM_LIGHT_SEL] * n_lights).to(torch.int32),
                    n_lights - 1,
                ).long()                                        # (B0, 128)
                ltid = scene.light_ids[li]
                # The light row by the JAX package's rule (integrator.py:
                # 655-664): a one-hot product up to ONEHOT_MAX_LIGHTS lights,
                # whose backward is a product too, a gather above.
                if n_lights <= ONEHOT_MAX_LIGHTS:
                    lrow = onehot_fetch(light_table, li)        # (16, B0, 128)
                else:
                    lrow = light_table[:, li]
                lv0 = lrow[0:3]
                lv1 = lrow[3:6]
                lv2 = lrow[6:9]
                lnormal = lrow[9:12]
                lke = lrow[12:15]
                larea = lrow[15]

                # v0 ~ U(0,1), v1 ~ U(0, 1-v0)  (rayTracer.cpp:96-97)
                b0 = un[prng.DIM_LIGHT_U]
                b1 = un[prng.DIM_LIGHT_V] * (1.0 - b0)
                lpoint = (
                    P.pscale(b0, lv0)
                    + P.pscale(b1, lv1)
                    + P.pscale(1.0 - b0 - b1, lv2)
                )

                to_light = lpoint - point
                dist = P.pnorm(to_light)
                wl = P.pnormalize(to_light)
                occluded = occluded_by(
                    nee_origin, P.pwhere(hit, wl, park_d), dist, ltid, li
                )
                geometric = torch.clamp_min(
                    P.pdot(normal, wl) * P.pdot(-wl, lnormal)
                    / (1.0 + dist * dist),
                    0.0,
                )
                f_nee = phong_f(wl) if scene.has_specular else f_brdf
                nee = lke * (geometric * larea * n_lights)[None] * f_nee
                direct = direct + P.pwhere(~occluded, nee, 0.0)

            # Point-light direct illumination (extension; no RNG consumed).
            no_excl = torch.full(B, -1, dtype=torch.int32, device=dev)
            for ipl in range(scene.n_point_lights):
                plp = scene.pl_pos[ipl][:, None, None]        # (3, 1, 1)
                ple = scene.pl_emit[ipl][:, None, None]
                to_l = plp - point
                pdist = P.pnorm(to_l)
                pwl = P.pnormalize(to_l)
                pocc = occluded_by(
                    nee_origin, P.pwhere(hit, pwl, park_d), pdist, no_excl
                )
                pgeo = torch.clamp_min(P.pdot(normal, pwl), 0.0) / (
                    1.0 + pdist * pdist
                )
                f_pl = phong_f(pwl) if scene.has_specular else f_brdf
                direct = direct + P.pwhere(~pocc, ple * pgeo[None] * f_pl, 0.0)

            radiance = radiance + P.pwhere(hit, throughput * direct, 0.0)

            # Extend the path (rayTracer.cpp:119-131).
            wi, pdf = sample_wi_diffuse_planar(
                normal, un[prng.DIM_BSDF_U], un[prng.DIM_BSDF_V]
            )
            if not scene.has_specular:
                kmax = f_brdf.amax(dim=0)
                survive = (pdf > 0.0) & (un[prng.DIM_RR] <= kmax)
                cosine = P.pdot(normal, wi).abs()
                scale = f_brdf * (
                    cosine / torch.where(pdf > 0.0, pdf * kmax, 1.0)
                )[None]
            else:
                # Mixture sampling: the cosine lobe or the Phong lobe, the
                # latter with probability p_spec = maxKs / (maxKd + maxKs); a
                # one-sample estimator with the mixture pdf.  Non-Phong lanes
                # have p_spec = 0 and reduce exactly to the branch above.
                max_kd = kd.amax(dim=0)
                max_ks = ks.amax(dim=0)
                p_spec = torch.where(
                    is_phong,
                    max_ks / torch.clamp_min(max_kd + max_ks, 1e-8),
                    0.0,
                )
                wi_s, _ = sample_phong_lobe_planar(
                    wr, ns, un[prng.DIM_BSDF_U], un[prng.DIM_BSDF_V]
                )
                choose_spec = un[prng.DIM_LOBE] < p_spec
                wi = P.pwhere(choose_spec, wi_s, wi)

                pdf_d = torch.clamp_min(P.pdot(normal, wi), 0.0) * M_1_PI
                pdf_s = phong_pdf_planar(wr, wi, ns)
                pdf_mix = (1.0 - p_spec) * pdf_d + p_spec * pdf_s

                f_at_wi = phong_f(wi)
                # Survival: the reference's Kmax on diffuse lanes; an
                # energy-bounded clamp on Phong lanes, whose lobes below the
                # surface are absorbed.
                q = torch.where(
                    is_phong,
                    torch.clamp(max_kd + max_ks, 0.05, 0.95),
                    f_brdf.amax(dim=0),
                )
                above = P.pdot(n_unit, wi) > 0.0
                survive = (pdf_mix > 0.0) & (un[prng.DIM_RR] <= q)
                survive = survive & (above | ~is_phong)
                cosine = P.pdot(normal, wi).abs()
                scale = f_at_wi * (
                    cosine / torch.where(pdf_mix > 0.0, pdf_mix * q, 1.0)
                )[None]

            new_active = hit & survive & (k < depth)
            throughput = P.pwhere(new_active, throughput * scale, throughput)
            origin = P.pwhere(new_active, point + EPS_OFFSET * normal, park_o)
            direction = P.pwhere(new_active, wi, park_d)
            stats[k - 1, 0] = active.sum()
            stats[k - 1, 1] = hit.sum()
            active = new_active

    if compact:
        # Back to pixel order: lane i holds the pixel perm[i] (an out-of-place
        # scatter, differentiable in radiance).
        flat = radiance.reshape(3, -1)
        radiance = flat.new_zeros(flat.shape).index_copy(
            1, perm.reshape(-1).long(), flat
        ).reshape((3,) + B)
    if with_stats:
        return radiance, stats
    return radiance
