"""OBJ/MTL asset ingest (pure Python + numpy, host-side).

Plays the role of the reference's Assimp import path (``src/model.cpp:25-114``)
with the same post-processing flags:

- *Triangulate*: polygon faces are fan-triangulated (v0,v1,v2),(v0,v2,v3),...
- *FlipUVs*: texture V coordinates are flipped (v -> 1-v) so that V=0 is the
  top image row, matching stb_image's top-left origin used by the reference's
  CPU texture fetch (``src/mesh.cpp:21-35``).
- *GenNormals*: when the OBJ supplies no ``vn``, flat per-face normals are
  generated (Assimp's aiProcess_GenNormals produces face normals).

The output is a list of :class:`Mesh` — one per (object, material) run, like
Assimp's one-aiMesh-per-material split — each carrying vertex positions,
normals, UVs, triangle indices, material colors and an optional diffuse
texture (``src/mesh.hpp:14-62``).

Emissive-material rule (reference quirk, SURVEY.md §2 C15): the reference
classifies a mesh as an area light iff the imported material's *emissive*
color has any positive channel (``src/kdtree.cpp:46-47``).  For ``.mtl`` files
that is ``Ke``.  The in-tree ``cornell_box.mtl`` instead encodes its light as
``Ka 20 20 20`` with no ``Ke``; to render such assets we additionally promote
``Ka`` to emissive when ``max(Ka) > ka_emissive_threshold`` (default 1.0 —
physically, ambient reflectance can never exceed 1, so any larger value must
mean radiance).  Set the threshold to ``inf`` to disable the promotion.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class MtlMaterial:
    name: str
    ka: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    kd: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    ks: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    ke: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    shininess: float = 0.0
    map_kd: Optional[str] = None     # diffuse texture path (relative to mtl dir)
    map_ks: Optional[str] = None     # specular map (loaded, preview-only in reference)
    map_bump: Optional[str] = None   # normal map (loaded, preview-only in reference)


@dataclasses.dataclass
class Mesh:
    """Per-(object, material) triangle batch, SoA. Mirrors reference ``Mesh``."""

    name: str
    positions: np.ndarray    # (V, 3) float32
    normals: np.ndarray      # (V, 3) float32
    uvs: np.ndarray          # (V, 2) float32 (post-FlipUVs)
    indices: np.ndarray      # (F, 3) int32
    diffuse: np.ndarray      # (3,) float32  Kd
    emissive: np.ndarray     # (3,) float32  Ke (after Ka promotion rule)
    ambient: np.ndarray      # (3,) float32  Ka
    specular: np.ndarray     # (3,) float32  Ks
    shininess: float
    texture_diffuse: Optional[str] = None   # resolved path or None
    texture_specular: Optional[str] = None  # resolved path or None
    texture_bump: Optional[str] = None      # normal map (model.cpp:104-111)

    @property
    def is_light(self) -> bool:
        # Reference emissive classification: src/kdtree.cpp:46-47.
        return bool((self.emissive > 0.0).any())


def _parse_floats(parts: List[str], n: int) -> np.ndarray:
    vals = [float(p) for p in parts[:n]]
    while len(vals) < n:
        vals.append(0.0)
    return np.asarray(vals, dtype=np.float32)


def load_mtl(path: str) -> Dict[str, MtlMaterial]:
    """Parse a Wavefront .mtl file. Missing file -> empty dict (warn)."""
    materials: Dict[str, MtlMaterial] = {}
    if not os.path.exists(path):
        print(f"WARNING: mtllib not found: {path}")
        return materials
    cur: Optional[MtlMaterial] = None
    with open(path, errors="replace") as f:
        for raw in f:
            parts = raw.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key, args = parts[0], parts[1:]
            if key == "newmtl":
                cur = MtlMaterial(name=args[0] if args else "")
                materials[cur.name] = cur
            elif cur is None:
                continue
            elif key == "Ka":
                cur.ka = _parse_floats(args, 3)
            elif key == "Kd":
                cur.kd = _parse_floats(args, 3)
            elif key == "Ks":
                cur.ks = _parse_floats(args, 3)
            elif key == "Ke":
                cur.ke = _parse_floats(args, 3)
            elif key == "Ns":
                cur.shininess = float(args[0])
            elif key.lower() == "map_kd":
                cur.map_kd = args[-1]
            elif key.lower() == "map_ks":
                cur.map_ks = args[-1]
            elif key.lower() in ("map_bump", "bump"):
                cur.map_bump = args[-1]
    return materials


def _resolve_index(idx: int, count: int) -> int:
    """OBJ indices are 1-based; negative indices count from the end."""
    return idx - 1 if idx > 0 else count + idx


def load_obj(
    path: str,
    flip_uvs: bool = True,
    gen_normals: bool = True,
    ka_emissive_threshold: float = 1.0,
) -> List[Mesh]:
    """Load an OBJ file into a list of per-(object, material) meshes."""
    directory = os.path.dirname(path)

    v: List[np.ndarray] = []
    vt: List[np.ndarray] = []
    vn: List[np.ndarray] = []
    materials: Dict[str, MtlMaterial] = {}

    # Face corners accumulated per (object, material) run, preserving file order.
    # Each corner is (v_idx, vt_idx|-1, vn_idx|-1).
    runs: List[Tuple[str, str, List[List[Tuple[int, int, int]]]]] = []
    cur_object = "default"
    cur_mtl = ""

    def current_run() -> List[List[Tuple[int, int, int]]]:
        if not runs or runs[-1][0] != cur_object or runs[-1][1] != cur_mtl:
            runs.append((cur_object, cur_mtl, []))
        return runs[-1][2]

    with open(path, errors="replace") as f:
        for raw in f:
            parts = raw.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            key, args = parts[0], parts[1:]
            if key == "v":
                v.append(_parse_floats(args, 3))
            elif key == "vt":
                vt.append(_parse_floats(args, 2))
            elif key == "vn":
                vn.append(_parse_floats(args, 3))
            elif key == "mtllib":
                materials.update(load_mtl(os.path.join(directory, " ".join(args))))
            elif key in ("o", "g"):
                cur_object = " ".join(args) if args else "default"
            elif key == "usemtl":
                cur_mtl = args[0] if args else ""
            elif key == "f":
                corners = []
                for spec in args:
                    comps = spec.split("/")
                    vi = _resolve_index(int(comps[0]), len(v))
                    ti = (
                        _resolve_index(int(comps[1]), len(vt))
                        if len(comps) > 1 and comps[1]
                        else -1
                    )
                    ni = (
                        _resolve_index(int(comps[2]), len(vn))
                        if len(comps) > 2 and comps[2]
                        else -1
                    )
                    corners.append((vi, ti, ni))
                current_run().append(corners)

    v_arr = np.asarray(v, dtype=np.float32) if v else np.zeros((0, 3), np.float32)
    vt_arr = np.asarray(vt, dtype=np.float32) if vt else np.zeros((0, 2), np.float32)
    vn_arr = np.asarray(vn, dtype=np.float32) if vn else np.zeros((0, 3), np.float32)
    if flip_uvs and len(vt_arr):
        vt_arr = vt_arr.copy()
        vt_arr[:, 1] = 1.0 - vt_arr[:, 1]

    meshes: List[Mesh] = []
    for obj_name, mtl_name, faces in runs:
        if not faces:
            continue
        mtl = materials.get(mtl_name, MtlMaterial(name=mtl_name))

        # Emissive rule: Ke, with high-Ka promotion (see module docstring).
        emissive = mtl.ke.copy()
        if float(emissive.max(initial=0.0)) <= 0.0 and float(
            mtl.ka.max(initial=0.0)
        ) > ka_emissive_threshold:
            emissive = mtl.ka.copy()

        positions: List[np.ndarray] = []
        normals: List[np.ndarray] = []
        uvs: List[np.ndarray] = []
        indices: List[Tuple[int, int, int]] = []
        corner_cache: Dict[Tuple[int, int, int], int] = {}

        def emit_corner(c: Tuple[int, int, int], flat_n: Optional[np.ndarray]) -> int:
            key = c if flat_n is None else (c[0], c[1], len(positions))
            if flat_n is None and key in corner_cache:
                return corner_cache[key]
            positions.append(v_arr[c[0]])
            uvs.append(vt_arr[c[1]] if c[1] >= 0 else np.zeros(2, np.float32))
            if c[2] >= 0:
                normals.append(vn_arr[c[2]])
            elif flat_n is not None:
                normals.append(flat_n)
            else:
                normals.append(np.zeros(3, np.float32))
            idx = len(positions) - 1
            if flat_n is None:
                corner_cache[key] = idx
            return idx

        for corners in faces:
            # Fan triangulation, as Assimp's aiProcess_Triangulate.
            for t in range(1, len(corners) - 1):
                tri = (corners[0], corners[t], corners[t + 1])
                flat_n = None
                if gen_normals and any(c[2] < 0 for c in tri):
                    p0, p1, p2 = (v_arr[c[0]] for c in tri)
                    n = np.cross(p1 - p0, p2 - p0)
                    ln = np.linalg.norm(n)
                    flat_n = (n / ln if ln > 0 else n).astype(np.float32)
                indices.append(tuple(emit_corner(c, flat_n) for c in tri))

        def resolve(rel):
            if not rel:
                return None
            cand = os.path.join(directory, rel)
            if os.path.exists(cand):
                return cand
            print(f"Texture failed to load at path: {rel}")
            return None

        tex_path = resolve(mtl.map_kd)
        tex_spec = resolve(mtl.map_ks)
        tex_bump = resolve(mtl.map_bump)

        meshes.append(
            Mesh(
                name=f"{obj_name}:{mtl_name}",
                positions=np.asarray(positions, dtype=np.float32),
                normals=np.asarray(normals, dtype=np.float32),
                uvs=np.asarray(uvs, dtype=np.float32),
                indices=np.asarray(indices, dtype=np.int32),
                diffuse=mtl.kd.copy(),
                emissive=emissive,
                ambient=mtl.ka.copy(),
                specular=mtl.ks.copy(),
                shininess=mtl.shininess,
                texture_diffuse=tex_path,
                texture_specular=tex_spec,
                texture_bump=tex_bump,
            )
        )
    return meshes


def load_texture(path: str) -> np.ndarray:
    """Decode an image file to a (H, W, 3) float32 array in [0, 1].

    Top-left origin, matching stb_image as used by the reference
    (``src/model.cpp:125``, ``src/mesh.cpp:21-35``).
    """
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0
