"""The reference's own scene tables, flattened from the frozen meshes.

What the port's ``build_scene_tensors`` derives from the meshes is worked out
again here, field by field as the reference renderer needs it: per-triangle
corners and edges, the stored normal (the mean of the three vertex normals,
not re-normalised), materials, texture coordinates and the packed texture
atlas, the emissive triangles with their areas, and the world bounds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

EMISSIVE = 1


@dataclasses.dataclass
class RefScene:
    v0: torch.Tensor        # (T, 3)
    v1: torch.Tensor        # (T, 3)
    v2: torch.Tensor        # (T, 3)
    e1: torch.Tensor        # (T, 3) v1 - v0
    e2: torch.Tensor        # (T, 3) v2 - v0
    normal: torch.Tensor    # (T, 3)
    kd: torch.Tensor        # (T, 3)
    ke: torch.Tensor        # (T, 3)
    emissive: torch.Tensor  # (T,) bool
    uv0: torch.Tensor       # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    tex_id: torch.Tensor    # (T,) int64, -1 where untextured
    tex_data: torch.Tensor  # (n_texels, 3)
    tex_offset: torch.Tensor  # (n_tex,) int64
    tex_width: torch.Tensor
    tex_height: torch.Tensor
    light_ids: torch.Tensor   # (L,) int64
    light_areas: torch.Tensor  # (L,)
    world_min: torch.Tensor   # (3,)
    world_max: torch.Tensor
    n_lights: int
    # float32 corners for the acceleration groups' boxes
    corners: np.ndarray = dataclasses.field(repr=False, default=None)

    @property
    def n_tris(self) -> int:
        return self.v0.shape[0]

    def with_materials(self, kd=None, ke=None) -> "RefScene":
        return dataclasses.replace(self, kd=self.kd if kd is None else kd,
                                   ke=self.ke if ke is None else ke)


def materials(meshes: Sequence, device, dtype=torch.float32):
    """The per-triangle diffuse and emissive tables (kd, ke), each (T, 3),
    in the order :func:`flatten` lays the triangles out."""
    kd = np.concatenate([np.broadcast_to(m.diffuse, (len(m.indices), 3)) for m in meshes])
    ke = np.concatenate([np.broadcast_to(m.emissive, (len(m.indices), 3)) for m in meshes])
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device).to(dtype)
                 for x in (kd, ke))


def flatten(meshes: Sequence, textures: Dict[str, np.ndarray], device,
            dtype=torch.float32) -> RefScene:
    """The scene tables of ``meshes`` on ``device``; floats in ``dtype``."""
    tex_paths, tex_index = [], {}
    for m in meshes:
        for p in (m.texture_diffuse, m.texture_specular, m.texture_bump):
            if p and p in textures and p not in tex_index:
                tex_index[p] = len(tex_paths)
                tex_paths.append(p)
    offsets, widths, heights, blobs, cursor = [], [], [], [], 0
    for p in tex_paths:
        img = np.asarray(textures[p], np.float32)
        h, w = img.shape[:2]
        offsets.append(cursor)
        widths.append(w)
        heights.append(h)
        blobs.append(img.reshape(-1, 3))
        cursor += h * w
    if not blobs:
        offsets, widths, heights, blobs = [0], [1], [1], [np.zeros((1, 3), np.float32)]

    cols = {k: [] for k in ("v0", "v1", "v2", "n", "em", "uv0", "uv1", "uv2", "tex")}
    light_ids, light_areas, base = [], [], 0
    for m in meshes:
        i0, i1, i2 = m.indices[:, 0], m.indices[:, 1], m.indices[:, 2]
        p, n, uv = m.positions, m.normals, m.uvs
        nt = len(m.indices)
        cols["v0"].append(p[i0])
        cols["v1"].append(p[i1])
        cols["v2"].append(p[i2])
        cols["n"].append((n[i0] + n[i1] + n[i2]) / 3.0)
        cols["em"].append(np.full(nt, m.is_light))
        cols["uv0"].append(uv[i0])
        cols["uv1"].append(uv[i1])
        cols["uv2"].append(uv[i2])
        tid = tex_index.get(m.texture_diffuse, -1) if m.texture_diffuse else -1
        cols["tex"].append(np.full(nt, tid, np.int64))
        if m.is_light:
            a, b, c = p[i0], p[i1], p[i2]
            light_areas.extend((0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)).tolist())
            light_ids.extend(range(base, base + nt))
        base += nt
    cat = {k: np.concatenate(v) for k, v in cols.items()}
    v0, v1, v2 = (cat[k].astype(np.float32) for k in ("v0", "v1", "v2"))
    pts = np.concatenate([v0, v1, v2])
    n_lights = len(light_ids)
    if n_lights == 0:
        light_ids, light_areas = [0], [0.0]

    def f(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device).to(dtype)

    def i(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(device)

    tv0, tv1, tv2 = f(v0), f(v1), f(v2)
    kd, ke = materials(meshes, device, dtype)
    return RefScene(
        v0=tv0, v1=tv1, v2=tv2, e1=tv1 - tv0, e2=tv2 - tv0, normal=f(cat["n"]),
        kd=kd, ke=ke,
        emissive=torch.from_numpy(cat["em"]).to(device),
        uv0=f(cat["uv0"]), uv1=f(cat["uv1"]), uv2=f(cat["uv2"]),
        tex_id=i(cat["tex"]), tex_data=f(np.concatenate(blobs)),
        tex_offset=i(offsets), tex_width=i(widths), tex_height=i(heights),
        light_ids=i(light_ids), light_areas=f(np.asarray(light_areas, np.float32)),
        world_min=f(pts.min(axis=0) - 1.0e-4), world_max=f(pts.max(axis=0) + 1.0e-4),
        n_lights=n_lights, corners=np.stack([v0, v1, v2], axis=1),
    )
