"""Scene compiler: scene-graph objects -> flat device-resident arrays.

The reference's ``Scene`` flattens every object's world-space vertices into
one global array, packs a std430 ``triangleStruct`` SoA with per-object
material broadcast via ``searchsorted``, builds the BVH, and uploads three GL
SSBOs (reference: scene.py:9-236).  Here the same flatten + material
broadcast happens in NumPy, but the "upload" is the construction of a
:class:`SceneData` pytree of JAX arrays — SoA with no GL padding (the
``_pad*`` fields in scene.py:45-70 are a std430 artifact we drop).

Differences from the reference's layout:

* triangles are stored as ``v0`` plus the two edges and the precomputed
  (non-unit) face normal ``cross(e1, e2)`` — the Möller–Trumbore inner loop
  (fragment.glsl:112-139) then needs no per-test cross product for the
  determinant;
* triangle arrays are permuted into BVH leaf order, so leaves are contiguous
  ranges and the reference's ``triangleIndices`` indirection buffer
  (fragment.glsl:102-104) disappears;
* arrays are padded to a multiple of 8 with degenerate (zero-area)
  triangles, which the intersector rejects via its existing parallel-ray
  epsilon test (fragment.glsl:120-123), so padding needs no special casing.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from opengl_raytracer_tpu.ops import bvh as bvh_mod


class SceneData(NamedTuple):
    """Device-resident scene (a JAX pytree; all float32 / int32).

    Triangle arrays are in BVH-permuted order when a BVH is present.
    Padded entries (index >= num_tris before permutation) are zero-area
    triangles that can never be hit.
    """

    v0: jnp.ndarray  # (T, 3) first vertex
    e1: jnp.ndarray  # (T, 3) v1 - v0  ("edgeAB", fragment.glsl:112)
    e2: jnp.ndarray  # (T, 3) v2 - v0  ("edgeAC", fragment.glsl:113)
    face: jnp.ndarray  # (T, 3) cross(e1, e2)  (fragment.glsl:116)
    n0: jnp.ndarray  # (T, 3) vertex normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    color: jnp.ndarray  # (T, 3)
    emission_color: jnp.ndarray  # (T, 3)
    emission: jnp.ndarray  # (T,)
    roughness: jnp.ndarray  # (T,)
    # BVH in DFS-preorder-with-miss-links layout; see ops/bvh.py.
    node_min: jnp.ndarray  # (N, 3)
    node_max: jnp.ndarray  # (N, 3)
    node_miss: jnp.ndarray  # (N,) int32
    node_first: jnp.ndarray  # (N,) int32
    node_count: jnp.ndarray  # (N,) int32
    # Shading data packed into ONE 24-wide row, so finalize_hit fetches a
    # hit's material and normals with one row gather.
    sh_abc: jnp.ndarray  # (T, 24) [n0.xyz, n1.xyz, emission, roughness,
    #                               n2.xyz, face.xyz, 0, 0,
    #                               color.xyz, emission_color.xyz, 0, 0]

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.node_miss.shape[0]


class Scene:
    """Flatten scene objects and compile device arrays.

    API mirrors the reference (scene.py:9): ``Scene(objects)`` plus the
    stats the app reads — ``total_triangles`` (scene.py:135) and
    ``total_boxes`` (scene.py:219).
    """

    def __init__(
        self,
        objects: list,
        max_leaf_tris: int = 32,
        build_bvh: bool = True,
        bvh_method: str = "sah",
        verbose: bool = False,
    ):
        if not objects:
            raise ValueError("Scene requires at least one object")
        self.objects = objects
        self.max_leaf_tris = max_leaf_tris

        pos_list, norm_list, uv_list, vertex_counts = [], [], [], []
        colors, emission_colors, surfaces = [], [], []
        for obj in objects:
            p = np.asarray(obj.pos, dtype=np.float32)
            pos_list.append(p)
            norm_list.append(np.asarray(obj.normals, dtype=np.float32))
            uv_list.append(np.asarray(obj.uvs, dtype=np.float32))
            vertex_counts.append(p.shape[0])
            colors.append(np.asarray(obj.color, dtype=np.float32))
            emission_colors.append(np.asarray(obj.emission_color, dtype=np.float32))
            if obj.emission < 0:
                # The integrator's reorder sort folds ``incoming`` into
                # dead rays' origin columns, which relies on live rays
                # carrying incoming == 0 — true only when light is added
                # exclusively at the death event (emission > 0 terminates,
                # fragment.glsl:338-343).  A negative emission would keep
                # the ray alive while accumulating light, silently dropping
                # it under reorder; reject it loudly at build instead.
                raise ValueError(
                    f"object {obj!r}: negative emission {obj.emission} is "
                    f"not supported (emissive hits must terminate paths)"
                )
            surfaces.append([obj.emission, obj.roughness])

        pos = np.vstack(pos_list) if pos_list else np.zeros((0, 3), np.float32)
        normals = np.vstack(norm_list) if norm_list else np.zeros((0, 3), np.float32)
        self.uvs = np.vstack(uv_list) if uv_list else np.zeros((0, 2), np.float32)

        n_vertices = pos.shape[0]
        n_tris = n_vertices // 3
        if n_vertices % 3 != 0 and verbose:
            print(
                f"Warning: {n_vertices % 3} leftover vertex/vertices ignored "
                f"when building triangles"
            )

        # Consume vertices three at a time (scene.py:89-111).
        self.v0 = pos[0::3][:n_tris]
        self.v1 = pos[1::3][:n_tris]
        self.v2 = pos[2::3][:n_tris]
        self.n0 = normals[0::3][:n_tris]
        self.n1 = normals[1::3][:n_tris]
        self.n2 = normals[2::3][:n_tris]

        # Per-object material broadcast to per-triangle (scene.py:113-133).
        starts = np.concatenate(([0], np.cumsum(vertex_counts)))
        tri_start_vertices = np.arange(n_tris) * 3
        tri_obj_idx = np.searchsorted(starts, tri_start_vertices, side="right") - 1
        tri_obj_idx = np.clip(tri_obj_idx, 0, max(len(vertex_counts) - 1, 0))

        colors_arr = np.vstack(colors).astype(np.float32)
        emc_arr = np.vstack(emission_colors).astype(np.float32)
        surface_arr = np.vstack(surfaces).astype(np.float32)
        self.color = colors_arr[tri_obj_idx]
        self.emission_color = emc_arr[tri_obj_idx]
        self.emission = surface_arr[tri_obj_idx, 0]
        self.roughness = surface_arr[tri_obj_idx, 1]

        self.total_triangles = n_tris

        self.bvh: bvh_mod.BVH | None = None
        if build_bvh and n_tris > 0:
            # Reference build banner + timing (scene.py:137-143); the
            # builder itself prints the per-slice progress bar.
            if verbose:
                print("\nSlicing bounding boxes...")
            t_build = time.time()
            self.bvh = bvh_mod.build_bvh(
                self.v0, self.v1, self.v2, max_leaf_tris, method=bvh_method,
                progress=verbose,
            )
            if verbose:
                print(f"Time taken: {round(time.time() - t_build, 2)} seconds")
        self.total_boxes = self.bvh.num_nodes if self.bvh is not None else 0

        if verbose:
            self._print_stats()

        self._device: SceneData | None = None

    def _print_stats(self) -> None:
        """Scene stats, mirroring the reference's post-upload print
        (scene.py:238-245)."""
        print("\n---Scene---")
        print(f"Number of triangles: {self.total_triangles:,}")
        print(f"Number of vertices: {self.total_triangles * 3:,}")
        print(f"Number of objects: {len(self.objects)}")
        if self.bvh is not None:
            counts = self.bvh.node_count[self.bvh.node_count > 0]
            print(f"\nNumber of bounding boxes: {self.total_boxes:,}")
            print(f"Avg number of triangles per bounding box: {counts.mean():.1f}")
            print(f"Min number of triangles per bounding box: {counts.min()}")
            print(f"Max number of triangles per bounding box: {counts.max()}")

    def send(self, pad_to: int = 8) -> SceneData:
        """Compile and place the scene on device (the reference's
        ``Scene.send`` SSBO upload, scene.py:145-236).  Idempotent."""
        if self._device is not None:
            return self._device

        if self.bvh is not None:
            perm = self.bvh.perm
        else:
            perm = np.arange(self.total_triangles, dtype=np.int64)

        def permute_pad(arr: np.ndarray) -> np.ndarray:
            arr = arr[perm]
            T = arr.shape[0]
            Tp = max(((T + pad_to - 1) // pad_to) * pad_to, pad_to)
            if Tp != T:
                pad_shape = (Tp - T,) + arr.shape[1:]
                arr = np.concatenate([arr, np.zeros(pad_shape, arr.dtype)], axis=0)
            return arr

        v0 = permute_pad(self.v0)
        v1 = permute_pad(self.v1)
        v2 = permute_pad(self.v2)
        e1 = v1 - v0
        e2 = v2 - v0
        face = np.cross(e1, e2)

        if self.bvh is not None:
            node_min = self.bvh.node_min
            node_max = self.bvh.node_max
            node_miss = self.bvh.node_miss
            node_first = self.bvh.node_first
            node_count = self.bvh.node_count
        else:
            # Single-leaf pseudo BVH covering everything (lets the traversal
            # path run even when BVH construction is disabled).
            node_min = np.minimum(np.minimum(v0, v1), v2).min(axis=0, keepdims=True)
            node_max = np.maximum(np.maximum(v0, v1), v2).max(axis=0, keepdims=True)
            node_miss = np.array([1], dtype=np.int32)
            node_first = np.array([0], dtype=np.int32)
            node_count = np.array([self.total_triangles], dtype=np.int32)

        n0p = permute_pad(self.n0)
        n1p = permute_pad(self.n1)
        n2p = permute_pad(self.n2)
        colp = permute_pad(self.color)
        emcp = permute_pad(self.emission_color)
        emp = permute_pad(self.emission)
        rgp = permute_pad(self.roughness)
        Tp = v0.shape[0]
        sh_abc = np.zeros((Tp, 24), np.float32)
        sh_abc[:, 0:3] = n0p
        sh_abc[:, 3:6] = n1p
        sh_abc[:, 6] = emp
        sh_abc[:, 7] = rgp
        sh_abc[:, 8:11] = n2p
        sh_abc[:, 11:14] = face
        sh_abc[:, 16:19] = colp
        sh_abc[:, 19:22] = emcp

        self._device = SceneData(
            v0=jnp.asarray(v0),
            e1=jnp.asarray(e1.astype(np.float32)),
            e2=jnp.asarray(e2.astype(np.float32)),
            face=jnp.asarray(face.astype(np.float32)),
            n0=jnp.asarray(n0p),
            n1=jnp.asarray(n1p),
            n2=jnp.asarray(n2p),
            color=jnp.asarray(colp),
            emission_color=jnp.asarray(emcp),
            emission=jnp.asarray(emp),
            roughness=jnp.asarray(rgp),
            node_min=jnp.asarray(node_min),
            node_max=jnp.asarray(node_max),
            node_miss=jnp.asarray(node_miss),
            node_first=jnp.asarray(node_first),
            node_count=jnp.asarray(node_count),
            sh_abc=jnp.asarray(sh_abc),
        )
        return self._device

    def clearMemory(self) -> None:
        """Release device arrays (reference: scene.py:423)."""
        self._device = None
