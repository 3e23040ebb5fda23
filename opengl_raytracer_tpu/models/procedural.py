"""Seeded procedural meshes: scene geometry that ships with the repository.

The reference's default scene loads two OBJ assets, a Stanford dragon and a
UV sphere (reference: main.py:19-35).  No asset can be fetched at run time,
so the default scene builds both in code:

* :func:`uv_sphere` — the reference sphere's own tessellation (64 segments,
  32 rings: 3,968 triangles) with smooth normals;
* :func:`blob` — the dragon's stand-in: a closed latitude-longitude sphere
  whose radius is displaced by seeded low-frequency noise, which gives it
  concavities and self-occlusion.  At its default resolution it has
  23,490 triangles, the minidragon's count, so the default scene totals
  27,542 like the minidragon scene.

Both return :class:`~opengl_raytracer_tpu.models.trisoup.Triangles` baked to
world space by the same ``bake_world`` transform as ``Mesh`` and ``Rect``.
"""

from __future__ import annotations

import numpy as np

from opengl_raytracer_tpu.models.transforms import bake_world
from opengl_raytracer_tpu.models.trisoup import Triangles

_RELIEF = 0.45  # blob radius varies by up to this fraction of 1


def latlong_faces(segments: int, rings: int) -> np.ndarray:
    """(2 * segments * (rings - 1), 3) int vertex indices of a closed
    latitude-longitude sphere, wound counter-clockwise seen from outside.

    Vertex 0 is the north pole, ``1 + (i - 1) * segments + j`` is ring
    ``i`` (1..rings-1) at longitude ``j``, and the last index is the south
    pole.  The caps are triangle fans; every band between two rings is a
    strip of quads split in two."""
    S, R = segments, rings
    south = 1 + (R - 1) * S
    j = np.arange(S)
    jn = (j + 1) % S

    def ring(i, jj):
        return 1 + (i - 1) * S + jj

    faces = [np.stack([np.zeros(S, int), ring(1, jn), ring(1, j)], axis=1)]
    for i in range(1, R - 1):
        a, b = ring(i, j), ring(i, jn)
        c, d = ring(i + 1, j), ring(i + 1, jn)
        faces.append(np.stack([a, d, c], axis=1))
        faces.append(np.stack([a, b, d], axis=1))
    faces.append(np.stack([ring(R - 1, j), ring(R - 1, jn), np.full(S, south)],
                          axis=1))
    return np.concatenate(faces)


def latlong_dirs(segments: int, rings: int) -> np.ndarray:
    """Unit directions of the :func:`latlong_faces` vertices, y up."""
    theta = np.pi * np.arange(1, rings) / rings
    phi = 2.0 * np.pi * np.arange(segments) / segments
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.cos(phi), np.broadcast_to(ct, (rings - 1, segments)),
                     st * np.sin(phi)], axis=-1).reshape(-1, 3)
    return np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals of an indexed mesh."""
    tri = verts[faces]
    face_n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    acc = np.zeros_like(verts)
    for k in range(3):
        np.add.at(acc, faces[:, k], face_n)
    return acc / np.linalg.norm(acc, axis=1, keepdims=True)


def _soup(verts, normals, faces, pos, eulers, scale, material) -> Triangles:
    s = np.broadcast_to(np.asarray(scale, np.float64), (3,))
    p, n = bake_world(verts[faces].reshape(-1, 3), normals[faces].reshape(-1, 3),
                      pos, eulers, s)
    return Triangles(p, n, **material)


def uv_sphere(pos, eulers, color=(0, 0, 0), emission_color=(0, 0, 0),
              emission=0.0, roughness=0.0, scale=1.0, segments: int = 64,
              rings: int = 32) -> Triangles:
    """Unit UV sphere with smooth (radial) normals; ``Mesh`` arguments."""
    dirs = latlong_dirs(segments, rings)
    return _soup(dirs, dirs, latlong_faces(segments, rings), pos, eulers, scale,
                 dict(color=color, emission_color=emission_color,
                      emission=emission, roughness=roughness))


def blob_vertices(seed: int, segments: int, rings: int) -> np.ndarray:
    """Vertices of a sphere whose radius is ``1 + _RELIEF * noise(dir)``.

    The noise is a seeded sum of twelve plane waves over the unit direction
    with frequencies 1.5-6 and amplitudes falling as 1/frequency, scaled so
    its peak magnitude is 1.  The object-space bottom is moved to y = -1,
    so a blob placed at ``y = floor + scale_y`` rests on the floor."""
    rng = np.random.default_rng(seed)
    k = 12
    axes = rng.normal(size=(k, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    freq = rng.uniform(1.5, 6.0, size=k)
    phase = rng.uniform(0.0, 2.0 * np.pi, size=k)
    dirs = latlong_dirs(segments, rings)
    noise = (np.sin(dirs @ (axes * freq[:, None]).T + phase) / freq).sum(axis=1)
    noise /= np.abs(noise).max()
    verts = dirs * (1.0 + _RELIEF * noise)[:, None]
    verts[:, 1] -= verts[:, 1].min() + 1.0
    return verts


def blob(pos, eulers, color=(0, 0, 0), emission_color=(0, 0, 0),
         emission=0.0, roughness=0.0, scale=1.0, seed: int = 0,
         segments: int = 135, rings: int = 88) -> Triangles:
    """Closed, non-convex noise-displaced sphere (the dragon's stand-in);
    ``Mesh`` arguments plus the seed and tessellation.  ``scale`` may be a
    scalar or per-axis."""
    verts = blob_vertices(seed, segments, rings)
    faces = latlong_faces(segments, rings)
    return _soup(verts, vertex_normals(verts, faces), faces, pos, eulers,
                 scale, dict(color=color, emission_color=emission_color,
                             emission=emission, roughness=roughness))
