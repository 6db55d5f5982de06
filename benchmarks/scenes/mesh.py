"""The mesh record of the frozen scene generators (plain numpy).

The fields of the port's ``scene/obj_loader.Mesh``, so that a driver can
hand each mesh to the port field by field and the reference can flatten the
same arrays itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Mesh:
    name: str
    positions: np.ndarray    # (V, 3) float32
    normals: np.ndarray      # (V, 3) float32
    uvs: np.ndarray          # (V, 2) float32
    indices: np.ndarray      # (F, 3) int32
    diffuse: np.ndarray      # (3,) float32 Kd
    emissive: np.ndarray     # (3,) float32 Ke
    ambient: np.ndarray      # (3,) float32 Ka
    specular: np.ndarray     # (3,) float32 Ks
    shininess: float
    texture_diffuse: Optional[str] = None
    texture_specular: Optional[str] = None
    texture_bump: Optional[str] = None

    @property
    def is_light(self) -> bool:
        return bool((self.emissive > 0.0).any())
