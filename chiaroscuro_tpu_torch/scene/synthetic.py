"""Synthetic sponza-scale scene: a procedural colonnaded atrium.

A copy of ``chiaroscuro_tpu/scene/synthetic.py`` (plain numpy), importing
the port's ``Mesh``; the meshes, textures and camera equal the JAX
package's exactly (tests/test_torch_synthetic.py).

The reference's flagship renders are sponza-class (``renders/sponza_crytek.exr``
1280x720, ``renders/sponza.exr``, ``renders/conference.exr``; its kd-tree
``src/kdtree.cpp:110-344`` exists for exactly these scenes), but the OBJ
assets themselves were never shipped (SURVEY.md §2 C15).  This module fills
that gap honestly: a fully procedural atrium — tessellated hall, two
colonnades, emissive ceiling panels, scattered crates — whose triangle count
is a parameter, so the HBM-streaming cluster kernels can be exercised and
benchmarked *at their design point* (packed cluster matrix above the VMEM
residency budget, ``ops/cluster_pallas.py`` ``RESIDENT_BUDGET_BYTES``).

Everything is plain numpy -> :class:`~chiaroscuro_tpu_torch.scene.obj_loader.Mesh`
lists, consumed by :func:`~chiaroscuro_tpu_torch.scene.scene_arrays.build_scene_tensors`
like any loaded OBJ.  Deterministic for a given (target_tris, seed).
"""

from __future__ import annotations

import zlib
from typing import List, Sequence

import numpy as np

from chiaroscuro_tpu_torch.scene.obj_loader import Mesh

# Hall dimensions (meters): x = length, y = height, z = width.
HALL_L = 24.0
HALL_H = 10.0
HALL_W = 12.0

# Camera looking down the hall from one end (analog of the shipped
# sponza_crytek.exr viewpoint: low, near a wall, facing the colonnade).
ATRIUM_CAMERA = dict(
    eye=(1.8, 4.2, 5.0),
    center=(24.0, 3.2, 6.8),
    up=(0.0, 1.0, 0.0),
    yview=0.9,
)


def _mesh(name, positions, normals, indices, kd, ke=(0.0, 0.0, 0.0),
          uvs=None, tex=None) -> Mesh:
    v = np.asarray(positions, np.float32).reshape(-1, 3)
    if uvs is None:
        uvs = np.zeros((len(v), 2), np.float32)
    return Mesh(
        name=name,
        positions=v,
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        indices=np.asarray(indices, np.int32).reshape(-1, 3),
        diffuse=np.asarray(kd, np.float32),
        emissive=np.asarray(ke, np.float32),
        ambient=np.zeros(3, np.float32),
        specular=np.zeros(3, np.float32),
        shininess=0.0,
        texture_diffuse=tex,
    )


def _grid_quad_indices(nu: int, nv: int) -> np.ndarray:
    """(2*nu*nv, 3) triangle indices over an (nu+1) x (nv+1) vertex grid."""
    i = np.arange(nu, dtype=np.int32)
    j = np.arange(nv, dtype=np.int32)
    jj, ii = np.meshgrid(j, i, indexing="ij")       # (nv, nu)
    a = jj * (nu + 1) + ii
    b = a + 1
    c = a + (nu + 1)
    d = c + 1
    return np.concatenate(
        [np.stack([a, b, d], -1).reshape(-1, 3),
         np.stack([a, d, c], -1).reshape(-1, 3)]
    )


def _grid_mesh(name, origin, du, dv, nu, nv, kd, ke=(0.0, 0.0, 0.0),
               tex=None, uv_period=3.0) -> Mesh:
    """Tessellated parallelogram: origin + u*du + v*dv, u in [0,nu], v in [0,nv].

    When ``tex`` is set, UVs span world units / ``uv_period`` so the texture
    repeats every ``uv_period`` meters (the atlas fetch wraps — parity with
    the reference's GL_REPEAT semantics, ``src/mesh.cpp:21-35``).
    """
    origin = np.asarray(origin, np.float32)
    du = np.asarray(du, np.float32)
    dv = np.asarray(dv, np.float32)
    u = np.arange(nu + 1, dtype=np.float32)
    v = np.arange(nv + 1, dtype=np.float32)
    pts = (origin[None, None]
           + u[None, :, None] * du[None, None]
           + v[:, None, None] * dv[None, None])     # (nv+1, nu+1, 3)
    n = np.cross(du, dv)
    n = (n / np.linalg.norm(n)).astype(np.float32)
    pts = pts.reshape(-1, 3)
    uvs = None
    if tex is not None:
        su = float(np.linalg.norm(du)) / uv_period
        sv = float(np.linalg.norm(dv)) / uv_period
        uvs = np.stack(
            np.broadcast_arrays(u[None, :] * su, v[:, None] * sv), -1
        ).reshape(-1, 2)
    return _mesh(name, pts, np.broadcast_to(n, pts.shape),
                 _grid_quad_indices(nu, nv), kd, ke, uvs=uvs, tex=tex)


def _cylinder_mesh(name, cx, cz, radius, y0, y1, nseg, nstack, kd,
                   tex=None, uv_period=3.0) -> Mesh:
    """Open cylinder (no caps — columns meet floor and ceiling)."""
    theta = np.linspace(0.0, 2 * np.pi, nseg + 1, dtype=np.float32)
    y = np.linspace(y0, y1, nstack + 1, dtype=np.float32)
    ct, st = np.cos(theta), np.sin(theta)
    px = cx + radius * ct[None, :].repeat(nstack + 1, 0)
    pz = cz + radius * st[None, :].repeat(nstack + 1, 0)
    py = y[:, None].repeat(nseg + 1, 1)
    pts = np.stack([px, py, pz], -1).reshape(-1, 3)
    nrm = np.stack(
        [ct[None, :].repeat(nstack + 1, 0),
         np.zeros_like(px),
         st[None, :].repeat(nstack + 1, 0)], -1,
    ).reshape(-1, 3)
    uvs = None
    if tex is not None:
        su = 2 * np.pi * radius / uv_period          # arclength-true wrap
        uu = (theta / (2 * np.pi) * su)[None, :].repeat(nstack + 1, 0)
        vv = (y / uv_period)[:, None].repeat(nseg + 1, 1)
        uvs = np.stack([uu, vv], -1).reshape(-1, 2)
    return _mesh(name, pts, nrm, _grid_quad_indices(nseg, nstack), kd,
                 uvs=uvs, tex=tex)


def _box_meshes(name, center, size, yaw, kd, tex=None, uv_period=1.5) -> List[Mesh]:
    """Axis-box rotated about y: six single-quad grids (flat normals)."""
    cx, cy, cz = center
    sx, sy, sz = size
    c, s = np.cos(yaw), np.sin(yaw)

    def rot(p):
        x, y, z = p
        return (cx + c * x - s * z, cy + y, cz + s * x + c * z)

    hx, hy, hz = sx / 2, sy / 2, sz / 2
    # du/dv ordered so cross(du, dv) faces OUT of the box (the integrator
    # shades with stored normals raw; an inward normal kills NEE's
    # max(0, dot(n, wl)) term and offsets shadow origins inside the box).
    faces = [
        ((-hx, -hy, -hz), (0, sy, 0), (sx, 0, 0)),   # front  (-z)
        ((hx, -hy, hz), (0, sy, 0), (-sx, 0, 0)),    # back   (+z)
        ((-hx, -hy, hz), (0, sy, 0), (0, 0, -sz)),   # left   (-x)
        ((hx, -hy, -hz), (0, sy, 0), (0, 0, sz)),    # right  (+x)
        ((-hx, hy, -hz), (0, 0, sz), (sx, 0, 0)),    # top    (+y)
        ((-hx, -hy, hz), (0, 0, -sz), (sx, 0, 0)),   # bottom (-y)
    ]
    out = []
    for fi, (origin, du, dv) in enumerate(faces):
        o = np.asarray(rot(origin), np.float32)
        duv = np.asarray(rot(du), np.float32) - np.asarray(rot((0, 0, 0)), np.float32)
        dvv = np.asarray(rot(dv), np.float32) - np.asarray(rot((0, 0, 0)), np.float32)
        out.append(_grid_mesh(f"{name}:f{fi}", o, duv, dvv, 1, 1, kd,
                              tex=tex, uv_period=uv_period))
    return out


# --------------------------------------------------------------------------
# Procedural textures ("proc:<kind>:<size>" paths)
#
# The reference's flagship scenes are texture-heavy (sponza/nanosuit diffuse
# maps decoded by ``src/model.cpp:116-174`` and fetched per-hit by
# ``src/mesh.cpp:21-35``); the shipped assets top out at ~10.5 M atlas texels
# (nanosuit).  These generators give the synthetic atrium an equally heavy
# atlas — at the default size, five 2048x2048 materials = ~21 M texels — so
# the streaming cluster path, in-kernel attribute fetch, and large-atlas
# gathers are exercised *together* at the sponza design point.  Deterministic
# per (kind, size); resolved by build_scene_tensors via proc_texture().
# --------------------------------------------------------------------------

def _upsample_wrap(g: np.ndarray, size: int) -> np.ndarray:
    """Bilinear upsample of a (c, c) grid to (size, size), wrapping edges."""
    c = g.shape[0]
    x = np.arange(size, dtype=np.float32) * (c / size)
    i0 = x.astype(np.int32)
    f = x - i0
    i1 = (i0 + 1) % c
    top = g[np.ix_(i0, i0)] * (1 - f)[None, :] + g[np.ix_(i0, i1)] * f[None, :]
    bot = g[np.ix_(i1, i0)] * (1 - f)[None, :] + g[np.ix_(i1, i1)] * f[None, :]
    return top * (1 - f)[:, None] + bot * f[:, None]


def _value_noise(size: int, cells: int, rng, octaves: int = 4) -> np.ndarray:
    """Multi-octave bilinear value noise in [0, 1], (size, size) float32."""
    img = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        c = min(cells * (2 ** o), size)
        img += amp * _upsample_wrap(
            rng.random((c, c)).astype(np.float32), size)
        total += amp
        amp *= 0.5
    return img / total


def _tint(field: np.ndarray, color, spread=0.35) -> np.ndarray:
    """(H, W) value field in [0,1] -> (H, W, 3) around ``color``."""
    col = np.asarray(color, np.float32)
    out = col[None, None] * (1.0 + spread * (field[..., None] * 2.0 - 1.0))
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def _tex_stone(size: int, rng) -> np.ndarray:
    n = _value_noise(size, 8, rng, octaves=5)
    speck = (rng.random((size, size)) < 0.02).astype(np.float32) * 0.25
    return _tint(np.clip(n + speck, 0, 1), (0.72, 0.68, 0.62), 0.30)


def _tex_plaster(size: int, rng) -> np.ndarray:
    return _tint(_value_noise(size, 4, rng, octaves=3),
                 (0.70, 0.66, 0.58), 0.18)


def _tex_brick(size: int, rng) -> np.ndarray:
    """Running-bond bricks with mortar lines and per-brick tone jitter."""
    bw, bh = size // 8, size // 16                   # brick cell in texels
    y, x = np.mgrid[0:size, 0:size]
    row = y // bh
    xs = x + (row % 2) * (bw // 2)                   # offset alternate rows
    col = xs // bw
    # per-brick hash -> tone jitter
    h = ((row * 2654435761 + col * 40503) & 0xFFFF).astype(np.float32) / 65535
    field = 0.5 + 0.5 * (h * 2 - 1) * 0.6
    field += (_value_noise(size, 16, rng, octaves=3) - 0.5) * 0.4
    brick = _tint(np.clip(field, 0, 1), (0.58, 0.40, 0.30), 0.35)
    mortar = ((y % bh) < bh // 8) | ((xs % bw) < bw // 12)
    return np.where(mortar[..., None],
                    np.float32((0.62, 0.60, 0.56)), brick).astype(np.float32)


def _tex_wood(size: int, rng) -> np.ndarray:
    """Plank grain: rings along u, plank seams along v."""
    y, x = np.mgrid[0:size, 0:size]
    warp = _value_noise(size, 6, rng, octaves=3)
    rings = 0.5 + 0.5 * np.sin(x / size * 40 * np.pi + warp * 9.0)
    plank = (y // (size // 6)).astype(np.float32)
    tone = 0.65 + 0.35 * ((plank * 2654435761 % 7) / 7.0)
    field = np.clip(rings * 0.5 + 0.3, 0, 1) * tone
    out = _tint(field, (0.50, 0.36, 0.22), 0.45)
    seam = (y % (size // 6)) < max(1, size // 256)
    return np.where(seam[..., None], out * 0.55, out).astype(np.float32)


def _tex_tile(size: int, rng) -> np.ndarray:
    """Floor: square stone tiles with grout and per-tile jitter."""
    t = size // 4
    y, x = np.mgrid[0:size, 0:size]
    tid = (y // t) * 7 + (x // t)
    h = ((tid * 2654435761) & 0xFFFF).astype(np.float32) / 65535
    field = 0.5 + (h - 0.5) * 0.5
    field += (_value_noise(size, 12, rng, octaves=4) - 0.5) * 0.35
    tile = _tint(np.clip(field, 0, 1), (0.55, 0.52, 0.48), 0.25)
    grout = ((y % t) < max(1, size // 170)) | ((x % t) < max(1, size // 170))
    return np.where(grout[..., None], tile * 0.55, tile).astype(np.float32)


_TEX_KINDS = {
    "stone": _tex_stone,
    "plaster": _tex_plaster,
    "brick": _tex_brick,
    "wood": _tex_wood,
    "tile": _tex_tile,
}

# Default per-material texture side at full scale: five 2048^2 materials
# ~= 21 M atlas texels (nanosuit's real atlas is ~10.5 M).
TEX_SIZE = 2048


def proc_texture(path: str) -> np.ndarray:
    """Resolve a ``proc:<kind>:<size>`` texture path to an (S, S, 3) float32
    array.  Deterministic: the RNG is seeded from (kind, size) only."""
    parts = path.split(":")
    if len(parts) != 3 or parts[0] != "proc":
        raise ValueError(f"not a procedural texture path: {path!r}")
    kind, size = parts[1], int(parts[2])
    if kind not in _TEX_KINDS:
        raise ValueError(
            f"unknown procedural texture {kind!r}; "
            f"available: {sorted(_TEX_KINDS)}")
    # zlib.crc32, not hash(): str hashing is salted per process.
    rng = np.random.default_rng(zlib.crc32(f"{kind}:{size}".encode()))
    return _TEX_KINDS[kind](size, rng)


def atrium(target_tris: int = 480_000, seed: int = 0,
           tex_size: int | None = None) -> List[Mesh]:
    """Procedural colonnaded atrium with ~``target_tris`` triangles.

    Geometry mix (so the intersector sees sponza-like structure, not a
    uniform soup): ~45% of the budget in 24 colonnade columns (curved,
    finely tessellated), ~55% in the hall's six tessellated surfaces, plus
    a fixed count of emissive ceiling panels (area lights for NEE) and
    jittered crates.  Deterministic for a given (target_tris, seed).

    Every non-emissive surface carries a procedural diffuse texture
    (``proc:*`` paths, see :func:`proc_texture`); ``tex_size`` is the
    per-material side — default 2048 at sponza scale (~21 M atlas texels,
    heavier than nanosuit's real 10.5 M) and 128 for small test scenes.
    """
    if tex_size is None:
        tex_size = TEX_SIZE if target_tris >= 100_000 else 128
    tx = {k: f"proc:{k}:{tex_size}" for k in _TEX_KINDS}
    rng = np.random.default_rng(seed)
    meshes: List[Mesh] = []

    # --- emissive ceiling panels (fixed: 24 light triangles) ------------
    eps = 0.02
    for i in range(4):
        for j in range(3):
            x0 = 2.5 + i * 5.5
            z0 = 2.0 + j * 3.5
            meshes.append(_grid_mesh(
                f"light_{i}_{j}:light", (x0, HALL_H - eps, z0),
                (2.2, 0, 0), (0, 0, 1.6), 1, 1,
                kd=(0.9, 0.9, 0.9), ke=(22.0, 21.0, 17.0),
            ))

    # --- crates (fixed: 60 boxes x 12 tris) ------------------------------
    for b in range(60):
        w = rng.uniform(0.5, 1.4)
        h = rng.uniform(0.5, 1.6)
        meshes.extend(_box_meshes(
            f"crate{b}:wood",
            (rng.uniform(2, HALL_L - 2), h / 2, rng.uniform(1, HALL_W - 1)),
            (w, h, w), rng.uniform(0, np.pi / 2),
            kd=(0.50, 0.36, 0.22), tex=tx["wood"],
        ))

    fixed = sum(len(m.indices) for m in meshes)
    budget = max(target_tris - fixed, 2_000)

    # --- colonnades: 2 rows x 12 columns ---------------------------------
    col_budget = int(budget * 0.45)
    n_cols = 24
    # tris per column = 2 * nseg * nstack, with nstack = 2 * nseg.
    nseg = max(4, int(np.sqrt(col_budget / n_cols / 4.0)))
    nstack = 2 * nseg
    k = 0
    for zrow in (3.0, 9.0):
        for i in range(12):
            meshes.append(_cylinder_mesh(
                f"col{k}:stone", 2.0 + i * 2.0, zrow, 0.35, 0.0, HALL_H,
                nseg, nstack, kd=(0.72, 0.68, 0.62), tex=tx["stone"],
                uv_period=2.0,
            ))
            k += 1

    # --- hall surfaces ----------------------------------------------------
    surf_budget = budget - 2 * nseg * nstack * n_cols
    # total surface area; per-surface grid density ~ sqrt(tris / (2*area))
    areas = {
        "floor": HALL_L * HALL_W, "ceiling": HALL_L * HALL_W,
        "wall_z0": HALL_L * HALL_H, "wall_z1": HALL_L * HALL_H,
        "wall_x0": HALL_W * HALL_H, "wall_x1": HALL_W * HALL_H,
    }
    density = max(surf_budget, 12.0) / (2.0 * sum(areas.values()))
    pitch = 1.0 / np.sqrt(max(density, 1e-6))

    def n_of(extent):
        return max(1, int(round(extent / pitch)))

    # du/dv ordered so cross(du, dv) faces the hall INTERIOR (floor up,
    # ceiling down, walls inward) — shading normals are used raw by the
    # integrator, so an outward normal makes the surface receive no light.
    surfs = [
        ("floor:stone", (0, 0, 0), (0, 0, HALL_W), (HALL_L, 0, 0),
         (0.55, 0.52, 0.48), tx["tile"], 4.0),
        ("ceiling:stone", (0, HALL_H, 0), (HALL_L, 0, 0), (0, 0, HALL_W),
         (0.62, 0.60, 0.58), tx["plaster"], 4.0),
        ("wall_z0:brick", (0, 0, 0), (HALL_L, 0, 0), (0, HALL_H, 0),
         (0.58, 0.40, 0.30), tx["brick"], 3.0),
        ("wall_z1:brick", (0, 0, HALL_W), (0, HALL_H, 0), (HALL_L, 0, 0),
         (0.58, 0.40, 0.30), tx["brick"], 3.0),
        ("wall_x0:plaster", (0, 0, 0), (0, HALL_H, 0), (0, 0, HALL_W),
         (0.70, 0.66, 0.58), tx["plaster"], 3.0),
        ("wall_x1:plaster", (HALL_L, 0, 0), (0, 0, HALL_W), (0, HALL_H, 0),
         (0.70, 0.66, 0.58), tx["plaster"], 3.0),
    ]
    for name, origin, du, dv, kd, tex, period in surfs:
        lu = float(np.linalg.norm(du))
        lv = float(np.linalg.norm(dv))
        nu, nv = n_of(lu), n_of(lv)
        meshes.append(_grid_mesh(
            name, origin,
            np.asarray(du, np.float32) / nu, np.asarray(dv, np.float32) / nv,
            nu, nv, kd, tex=tex, uv_period=period,
        ))
    return meshes


def atrium_tri_count(meshes: Sequence[Mesh]) -> int:
    return sum(len(m.indices) for m in meshes)
