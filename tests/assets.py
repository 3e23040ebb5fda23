"""OBJ files written from the generated meshes, so tests of the OBJ path
(parser, asset resolution, ``Mesh``) need no asset on disk."""

from __future__ import annotations

import numpy as np


def write_obj(path, obj) -> str:
    """Write a triangle soup (``.pos``/``.normals`` of 3T rows, as on
    ``Triangles``) as an OBJ with one ``v``/``vn`` pair per corner and
    ``v//n`` faces.  ``%.9g`` round-trips float32 exactly."""
    pos = np.asarray(obj.pos, np.float32)
    nrm = np.asarray(obj.normals, np.float32)
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in pos]
    lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in nrm]
    lines += [f"f {i + 1}//{i + 1} {i + 2}//{i + 2} {i + 3}//{i + 3}"
              for i in range(0, pos.shape[0], 3)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)
