"""SceneTensors: the device-resident structure-of-arrays scene.

The torch counterpart of ``chiaroscuro_tpu/scene/scene_arrays.py``'s
``SceneArrays``: the reference's flattened triangle/material vectors
(``src/kdtree.cpp:34-108``) as flat tensors indexed by triangle id, with the
same field names, shapes and dtypes (f32, int32 ids), plus the four static
fields.

- Textures of arbitrary sizes are packed into one flat ``(n_texels, 3)``
  buffer with per-texture (offset, width, height), so one gather serves
  every texture.
- Per-triangle ``normal`` is the *mean of the three vertex normals, not
  re-normalized*, exactly as the reference stores it (``src/kdtree.cpp:58-60``);
  the integrator's cosine terms use it raw.

Differentiable parameters: ``scene.replace(kd=kd, ...)`` returns the scene
with the given data fields substituted (the counterpart of
``dataclasses.replace(scene, **params)`` on the JAX ``SceneArrays``), and
:func:`params_from_numpy` turns a numpy parameter dict into leaf tensors
that require grad.  Intersectors built from the substituted scene carry the
gradients (``accel/dispatch.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from chiaroscuro_tpu_torch.scene.config import RenderConfig
from chiaroscuro_tpu_torch.scene.obj_loader import Mesh, load_obj, load_texture

BRDF_DIFFUSE = 0
BRDF_EMISSIVE = 1
BRDF_PHONG = 2   # diffuse + Phong specular lobe (extension; see integrator)

DATA_FIELDS = (
    "tri_v0", "tri_v1", "tri_v2", "normal",
    "kd", "ke", "ks", "shininess", "brdf_type",
    "uv0", "uv1", "uv2", "tex_id", "tex_id_ks", "tex_id_bump",
    "tex_data", "tex_offset", "tex_width", "tex_height",
    "light_ids", "light_areas", "pl_pos", "pl_emit",
    "world_min", "world_max",
)
META_FIELDS = ("n_tris", "n_lights", "n_point_lights", "has_specular")


@dataclasses.dataclass
class SceneTensors:
    # --- geometry ---
    tri_v0: torch.Tensor  # (T, 3) f32 triangle corner positions
    tri_v1: torch.Tensor  # (T, 3)
    tri_v2: torch.Tensor  # (T, 3)
    normal: torch.Tensor  # (T, 3) mean-of-vertex-normals, NOT unit (kdtree.cpp:58-60)

    # --- material params ---
    kd: torch.Tensor      # (T, 3) diffuse albedo
    ke: torch.Tensor      # (T, 3) emitted radiance
    ks: torch.Tensor      # (T, 3) specular reflectance (Phong extension)
    shininess: torch.Tensor  # (T,) Phong exponent Ns
    brdf_type: torch.Tensor  # (T,) int32: BRDF_DIFFUSE | BRDF_EMISSIVE | BRDF_PHONG

    # --- texturing ---
    uv0: torch.Tensor     # (T, 2) per-corner texcoords (post-FlipUVs)
    uv1: torch.Tensor     # (T, 2)
    uv2: torch.Tensor     # (T, 2)
    tex_id: torch.Tensor  # (T,) int32 index into texture table, -1 = untextured
    tex_id_ks: torch.Tensor    # (T,) int32 specular-map index, -1 = none
    tex_id_bump: torch.Tensor  # (T,) int32 normal-map index (never sampled)
    tex_data: torch.Tensor     # (n_texels, 3) f32 flat texel buffer
    tex_offset: torch.Tensor   # (n_tex,) int32 start offset into tex_data
    tex_width: torch.Tensor    # (n_tex,) int32
    tex_height: torch.Tensor   # (n_tex,) int32

    # --- area lights (emissive triangles, kdtree.cpp:72-77) ---
    light_ids: torch.Tensor    # (L,) int32 triangle ids (L >= 1; dummy if no lights)
    light_areas: torch.Tensor  # (L,) f32 triangle surface areas

    # --- point lights (extension; the legacy `L` lines, see SceneArrays) ---
    pl_pos: torch.Tensor       # (P, 3) f32 positions (P may be 0)
    pl_emit: torch.Tensor      # (P, 3) f32 radiant intensity = color/255 * I

    # --- world bounds (kdtree.cpp:106-107, padded by 1e-4) ---
    world_min: torch.Tensor    # (3,) f32
    world_max: torch.Tensor    # (3,) f32

    # --- static metadata ---
    n_tris: int = 0
    n_lights: int = 0
    n_point_lights: int = 0
    # True iff any triangle uses BRDF_PHONG (the integrator does not shade
    # it yet; False keeps exact reference-estimator parity).
    has_specular: bool = False

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def replace(self, **fields: torch.Tensor) -> "SceneTensors":
        """This scene with the given data fields substituted, e.g. leaf
        tensors that require grad: ``scene.replace(kd=kd, ke=ke)``.  Each
        substitute must be a tensor of the field's shape, dtype and device,
        so the static metadata (triangle and light counts) stays true;
        nothing is copied or detached."""
        for name, value in fields.items():
            if name not in DATA_FIELDS:
                raise ValueError(f"{name!r} is not a data field of SceneTensors")
            old = getattr(self, name)
            if not isinstance(value, torch.Tensor) or (
                value.shape, value.dtype, value.device
            ) != (old.shape, old.dtype, old.device):
                raise ValueError(
                    f"{name} must be a {old.dtype} tensor of shape "
                    f"{tuple(old.shape)} on {old.device}"
                )
        return dataclasses.replace(self, **fields)


def triangle_areas(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """0.5 * |cross(v1-v0, v2-v0)| (reference ``kdtree.cpp:72-77``)."""
    return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)


def scene_tensors_from_numpy(
    fields: Mapping[str, np.ndarray], meta: Mapping, device
) -> SceneTensors:
    """SceneTensors from numpy arrays keyed by ``DATA_FIELDS`` and static
    values keyed by ``META_FIELDS`` — e.g. a JAX ``SceneArrays`` read out
    field by field, so that both packages render the very same scene."""
    data = {
        k: torch.from_numpy(np.array(fields[k])).to(device)
        for k in DATA_FIELDS
    }
    return SceneTensors(**data, **{k: meta[k] for k in META_FIELDS})


def params_from_numpy(
    params: Mapping[str, np.ndarray], device
) -> Dict[str, torch.Tensor]:
    """Leaf tensors on ``device`` from a numpy parameter dict keyed by data
    fields (e.g. the JAX parameters ``{"kd": ..., "ke": ..., "tri_v0": ...,
    "tex_data": ...}`` read out as numpy), each requiring grad, ready for
    :meth:`SceneTensors.replace`."""
    out = {}
    for name, value in params.items():
        if name not in DATA_FIELDS:
            raise ValueError(f"{name!r} is not a data field of SceneTensors")
        t = torch.from_numpy(np.array(value)).to(device)
        out[name] = t.requires_grad_(t.is_floating_point())
    return out


def build_scene_tensors(
    meshes: Sequence[Mesh],
    textures: Optional[Dict[str, np.ndarray]] = None,
    enable_specular: bool = False,
    point_lights: Sequence = (),
    device="cpu",
) -> SceneTensors:
    """Flatten meshes into SceneTensors (reference ``kdtree.cpp:34-108``);
    mirrors ``build_scene_arrays`` field by field.

    ``textures`` maps texture path -> (H, W, 3) float32 array; when None,
    each mesh's texture paths are decoded from disk.

    ``enable_specular``: classify non-emissive meshes with max(Ks) > 0 as
    ``BRDF_PHONG``.  Default False = the reference's two-type system
    (``brdf.hpp:8``) for exact estimator parity.
    """
    if textures is None:
        textures = {}
        for m in meshes:
            for p in (
                m.texture_diffuse,
                m.texture_specular if enable_specular else None,
                m.texture_bump,
            ):
                if p and p not in textures:
                    if p.startswith("proc:"):
                        # synthetic scenes carry procedural texture paths
                        # (scene/synthetic.py) instead of files on disk
                        from chiaroscuro_tpu_torch.scene.synthetic import (
                            proc_texture,
                        )

                        textures[p] = proc_texture(p)
                    else:
                        textures[p] = load_texture(p)

    # Texture table: dedup by path, pack into a flat texel buffer.
    tex_paths: List[str] = []
    tex_index: Dict[str, int] = {}
    for m in meshes:
        for p in (m.texture_diffuse, m.texture_specular, m.texture_bump):
            if p and p in textures and p not in tex_index:
                tex_index[p] = len(tex_paths)
                tex_paths.append(p)

    offsets, widths, heights, blobs = [], [], [], []
    cursor = 0
    for p in tex_paths:
        img = np.asarray(textures[p], dtype=np.float32)
        h, w = img.shape[:2]
        offsets.append(cursor)
        widths.append(w)
        heights.append(h)
        blobs.append(img.reshape(-1, 3))
        cursor += h * w
    if not blobs:  # keep shapes non-empty: one dummy texel
        offsets, widths, heights = [0], [1], [1]
        blobs = [np.zeros((1, 3), np.float32)]

    v0s, v1s, v2s, nrms, kds, kes, types = [], [], [], [], [], [], []
    kss, nss = [], []
    uv0s, uv1s, uv2s, tids, tids_ks, tids_bump = [], [], [], [], [], []
    light_ids, light_areas = [], []
    tri_base = 0
    for m in meshes:
        idx = m.indices
        p = m.positions
        n = m.normals
        uv = m.uvs
        i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
        nt = len(idx)
        v0s.append(p[i0]); v1s.append(p[i1]); v2s.append(p[i2])
        nrms.append((n[i0] + n[i1] + n[i2]) / 3.0)
        uv0s.append(uv[i0]); uv1s.append(uv[i1]); uv2s.append(uv[i2])
        kds.append(np.broadcast_to(m.diffuse, (nt, 3)))
        kes.append(np.broadcast_to(m.emissive, (nt, 3)))
        kss.append(np.broadcast_to(m.specular, (nt, 3)))
        nss.append(np.full(nt, max(float(m.shininess), 1.0), np.float32))
        is_light = m.is_light
        if is_light:
            btype = BRDF_EMISSIVE
        elif enable_specular and float(np.max(m.specular)) > 0.0:
            btype = BRDF_PHONG
        else:
            btype = BRDF_DIFFUSE
        types.append(np.full(nt, btype, np.int32))
        tid = tex_index.get(m.texture_diffuse, -1) if m.texture_diffuse else -1
        tids.append(np.full(nt, tid, np.int32))
        tid_ks = (
            tex_index.get(m.texture_specular, -1) if m.texture_specular else -1
        )
        tids_ks.append(np.full(nt, tid_ks if enable_specular else -1, np.int32))
        tid_bump = (
            tex_index.get(m.texture_bump, -1) if m.texture_bump else -1
        )
        tids_bump.append(np.full(nt, tid_bump, np.int32))
        if is_light:
            areas = triangle_areas(p[i0], p[i1], p[i2])
            light_ids.extend(range(tri_base, tri_base + nt))
            light_areas.extend(areas.tolist())
        tri_base += nt

    tri_v0 = np.concatenate(v0s).astype(np.float32)
    tri_v1 = np.concatenate(v1s).astype(np.float32)
    tri_v2 = np.concatenate(v2s).astype(np.float32)
    n_tris = len(tri_v0)
    n_lights = len(light_ids)
    if n_lights == 0:
        light_ids, light_areas = [0], [0.0]

    all_pts = np.concatenate([tri_v0, tri_v1, tri_v2])
    world_min = all_pts.min(axis=0) - 1.0e-4  # kdtree.cpp:106-107
    world_max = all_pts.max(axis=0) + 1.0e-4

    n_pl = len(point_lights)
    pl_pos = np.zeros((n_pl, 3), np.float32)
    pl_emit = np.zeros((n_pl, 3), np.float32)
    for i, lp in enumerate(point_lights):
        pl_pos[i] = np.asarray(lp.position, np.float32)
        pl_emit[i] = (
            np.asarray(lp.color, np.float32) / 255.0 * float(lp.intensity)
        )

    fields = dict(
        tri_v0=tri_v0,
        tri_v1=tri_v1,
        tri_v2=tri_v2,
        normal=np.concatenate(nrms).astype(np.float32),
        kd=np.concatenate(kds).astype(np.float32),
        ke=np.concatenate(kes).astype(np.float32),
        ks=np.concatenate(kss).astype(np.float32),
        shininess=np.concatenate(nss).astype(np.float32),
        brdf_type=np.concatenate(types),
        uv0=np.concatenate(uv0s).astype(np.float32),
        uv1=np.concatenate(uv1s).astype(np.float32),
        uv2=np.concatenate(uv2s).astype(np.float32),
        tex_id=np.concatenate(tids),
        tex_id_ks=np.concatenate(tids_ks),
        tex_id_bump=np.concatenate(tids_bump),
        tex_data=np.concatenate(blobs).astype(np.float32),
        tex_offset=np.asarray(offsets, np.int32),
        tex_width=np.asarray(widths, np.int32),
        tex_height=np.asarray(heights, np.int32),
        light_ids=np.asarray(light_ids, np.int32),
        light_areas=np.asarray(light_areas, np.float32),
        pl_pos=pl_pos,
        pl_emit=pl_emit,
        world_min=world_min.astype(np.float32),
        world_max=world_max.astype(np.float32),
    )
    meta = dict(
        n_tris=n_tris,
        n_lights=n_lights,
        n_point_lights=n_pl,
        has_specular=bool(
            enable_specular
            and any(int(t[0]) == BRDF_PHONG for t in types if len(t))
        ),
    )
    return scene_tensors_from_numpy(fields, meta, device)


def load_scene(cfg: RenderConfig, device, **obj_kwargs) -> SceneTensors:
    """Config -> meshes -> SceneTensors on ``device``.

    ``input`` paths of the form ``builtin:<name>`` resolve to the programmatic
    scenes in :mod:`chiaroscuro_tpu_torch.scene.builtin` (e.g.
    ``builtin:cornell_box``), ``synthetic:<gen>[:<tris>]`` to the generators
    in :mod:`chiaroscuro_tpu_torch.scene.synthetic` (e.g.
    ``synthetic:atrium:480000``); anything else is an OBJ file.
    """
    if cfg.obj_path.startswith("builtin:"):
        from chiaroscuro_tpu_torch.scene import builtin

        name = cfg.obj_path.split(":", 1)[1]
        meshes = getattr(builtin, name)()
    elif cfg.obj_path.startswith("synthetic:"):
        from chiaroscuro_tpu_torch.scene import synthetic

        parts = cfg.obj_path.split(":")
        generators = {"atrium": synthetic.atrium}
        if parts[1] not in generators:
            raise ValueError(
                f"unknown synthetic generator {parts[1]!r}; "
                f"available: {sorted(generators)}"
            )
        gen = generators[parts[1]]
        meshes = gen(int(parts[2])) if len(parts) > 2 else gen()
    else:
        meshes = load_obj(cfg.obj_path, **obj_kwargs)
    scene = build_scene_tensors(
        meshes,
        enable_specular=cfg.enable_specular,
        point_lights=cfg.light_points if cfg.use_point_lights else (),
        device=device,
    )
    _log_scene(scene)
    return scene


def _log_scene(scene: SceneTensors) -> None:
    # Parity with the reference's scene statistics banner (kdtree.cpp:91-104).
    print(f"Triangles in scene: {scene.n_tris}")
    print(
        "Surface Lights in scene:"
        + (f" {scene.n_lights}" if scene.n_lights else " None.")
    )
