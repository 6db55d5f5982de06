"""The classic Cornell box, frozen for the benchmark.

A copy of the port's ``scene/builtin.py::cornell_box`` (the Cornell
University Program of Computer Graphics data, cm scale, with the ceiling
light enabled) as it stood when the benchmark was defined.  Plain numpy: it
imports nothing of the port.
"""

from __future__ import annotations

from typing import List

import numpy as np

from benchmarks.scenes.mesh import Mesh


def _quad_mesh(name, quads, kd, ke=(0.0, 0.0, 0.0)) -> Mesh:
    """Build a Mesh from a list of quads (each 4 CCW corners), fan-triangulated
    with flat normals — matching the OBJ loader's GenNormals path."""
    positions: List[np.ndarray] = []
    normals: List[np.ndarray] = []
    indices: List[tuple] = []
    for quad in quads:
        q = [np.asarray(c, np.float32) for c in quad]
        for tri in [(0, 1, 2), (0, 2, 3)]:
            p0, p1, p2 = q[tri[0]], q[tri[1]], q[tri[2]]
            n = np.cross(p1 - p0, p2 - p0)
            ln = np.linalg.norm(n)
            n = (n / ln if ln > 0 else n).astype(np.float32)
            base = len(positions)
            positions += [p0, p1, p2]
            normals += [n, n, n]
            indices.append((base, base + 1, base + 2))
    v = np.asarray(positions, np.float32)
    return Mesh(
        name=name,
        positions=v,
        normals=np.asarray(normals, np.float32),
        uvs=np.zeros((len(v), 2), np.float32),
        indices=np.asarray(indices, np.int32),
        diffuse=np.asarray(kd, np.float32),
        emissive=np.asarray(ke, np.float32),
        ambient=np.zeros(3, np.float32),
        specular=np.zeros(3, np.float32),
        shininess=0.0,
    )


def cornell_box(light_ke=(20.0, 20.0, 20.0)) -> List[Mesh]:
    """The classic Cornell box (cm scale, cornell.graphics.cornell.edu data)
    with an emissive ceiling light — the in-tree asset's geometry with the
    commented-out light face (``data/cornell_box.obj``) enabled."""
    white = (1.0, 1.0, 1.0)
    meshes = [
        _quad_mesh(
            "floor:white",
            [
                [(552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2)],
                [(290, 0, 114), (240, 0, 272), (82, 0, 225), (130, 0, 65)],
                [(472, 0, 406), (314, 0, 456), (265, 0, 296), (423, 0, 247)],
            ],
            white,
        ),
        _quad_mesh(
            "light:light",
            [[(343, 548, 227), (343, 548, 332), (213, 548, 332), (213, 548, 227)]],
            white,
            light_ke,
        ),
        _quad_mesh(
            "ceiling:white",
            [[(556, 548.8, 0), (556, 548.8, 559.2), (0, 548.8, 559.2), (0, 548.8, 0)]],
            white,
        ),
        _quad_mesh(
            "back_wall:white",
            [[(549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2), (556, 548.8, 559.2)]],
            white,
        ),
        _quad_mesh(
            "green_wall:green",
            [[(0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2)]],
            (0.0, 1.0, 0.0),
        ),
        _quad_mesh(
            "red_wall:red",
            [[(552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2), (556, 548.8, 0)]],
            (1.0, 0.0, 0.0),
        ),
        _quad_mesh(
            "short_block:white",
            [
                [(130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)],
                [(290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)],
                [(130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)],
                [(82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)],
                [(240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)],
            ],
            white,
        ),
        _quad_mesh(
            "tall_block:white",
            [
                [(423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)],
                [(423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)],
                [(472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)],
                [(314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)],
                [(265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)],
            ],
            white,
        ),
    ]
    return meshes


# Default camera for :func:`cornell_box` framing the open face, chosen to
# mirror the classic Cornell camera (278, 273, -800 looking down +z).
CORNELL_CAMERA = dict(
    eye=(278.0, 273.0, -800.0),
    center=(278.0, 273.0, 0.0),
    up=(0.0, 1.0, 0.0),
    yview=0.7,
)


def inputs(scene: dict):
    """A configuration's scene inputs (``generator: cornell``): the box's
    meshes, with no textures."""
    return cornell_box(), {}
