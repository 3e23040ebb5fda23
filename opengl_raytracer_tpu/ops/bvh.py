"""BVH construction (host side).

The reference builds a top-down binary BVH by splitting every node at the
*centroid mean along the largest-extent axis* for a fixed number of rounds,
then flattens to ``(numTriangles, triangleOffset, childA, childB, posMin,
posMax)`` nodes plus a triangle-index list (reference: boundingBoxes.pyx:9-132,
sliceBoundingBox boundingBoxes.pyx:162-175, flatten scene.py:148-221).

This builder keeps the same split rule (mean split on the max-extent axis of
triangle centroids, centroids = mean of the three vertices, scene.py:94-97)
but emits a stackless, vectorizable layout instead of the GL one:

* nodes are stored in **DFS preorder with miss links** ("skip pointers"), so
  device traversal needs no per-ray stack: on AABB hit an internal node falls
  through to ``i + 1`` (its left child), on miss (or after a leaf) it jumps to
  ``miss[i]``; index ``num_nodes`` is the termination sentinel.  This replaces
  the reference's divergent 128-deep traversal stack (fragment.glsl:250-252)
  with a single vectorizable per-ray index.
* leaf triangle ranges are contiguous because the builder also returns the
  triangle permutation; the scene permutes its triangle arrays once at build
  so traversal does not need the reference's extra ``triangleIndices``
  indirection (fragment.glsl:102-104).
* every leaf holds at most ``max_leaf_tris`` triangles, so the device leaf
  loop is a fixed-length masked loop.  (The reference instead runs a fixed
  ``ceil(log2 n) - 1`` split rounds, giving unbounded leaf sizes; and its
  one-child nodes are demoted to leaves with orphaned duplicate subtrees,
  scene.py:168-179 — a quirk we do not reproduce since BVH topology does not
  affect the rendered image, only which structure finds the same nearest hit.)

Unsplittable nodes (all centroids identical on the split axis) fall back to an
even index split so the leaf-size bound always holds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BVH(NamedTuple):
    """Flattened BVH in DFS preorder with miss links (host numpy arrays)."""

    node_min: np.ndarray  # (N, 3) float32 AABB lower corners
    node_max: np.ndarray  # (N, 3) float32 AABB upper corners
    node_miss: np.ndarray  # (N,) int32; jump target on AABB miss / after leaf
    node_first: np.ndarray  # (N,) int32; first triangle (in permuted order), leaves only
    node_count: np.ndarray  # (N,) int32; triangles in leaf, 0 for internal nodes
    perm: np.ndarray  # (T,) int64; permuted-order -> original triangle index
    depth: int  # maximum node depth (root = 0)

    @property
    def num_nodes(self) -> int:
        return int(self.node_miss.shape[0])


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              max_leaf_tris: int = 16, method: str = "sah",
              prefer_native: bool = True,
              progress: bool | None = None) -> BVH:
    """Build a BVH over triangles given as three (T, 3) arrays.

    method: "mean" (the reference's centroid-mean split) or "sah" (binned
    surface-area heuristic; native builder only).  Prefers the C++ builder
    (native/bvh.cpp) and falls back to the pure-NumPy mean-split twin below
    when no compiler is available — mirroring the reference's compiled/
    interpreted module pairing (boundingBoxes.pyx vs scene.py:274-421).
    progress prints the reference-style carriage-return percent bar during
    the build (boundingBoxes.pyx:64-65); default auto (tty only).
    """
    from opengl_raytracer_tpu.utils.progress import progress_enabled

    show = progress_enabled(progress)
    if prefer_native:
        try:
            from opengl_raytracer_tpu.native import loader

            bvh = loader.build_bvh_native(
                v0, v1, v2, max_leaf_tris,
                method=1 if method == "sah" else 0, progress=show,
            )
            if bvh is not None:
                return bvh
        except Exception:
            pass
    return build_bvh_numpy(v0, v1, v2, max_leaf_tris, progress=show)


def build_bvh_numpy(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                    max_leaf_tris: int = 16,
                    progress: bool = False) -> BVH:
    """Pure-NumPy mean-split builder (the readable spec of the native one)."""
    T = v0.shape[0]
    if T == 0:
        raise ValueError("cannot build a BVH over zero triangles")

    centroids = (v0 + v1 + v2) / 3.0
    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)

    node_min: list[np.ndarray] = []
    node_max: list[np.ndarray] = []
    node_first: list[int] = []
    node_count: list[int] = []
    node_children: list[tuple[int, int]] = []  # (-1, -1) for leaves
    node_depth: list[int] = []
    perm_chunks: list[np.ndarray] = []
    perm_offset = 0

    # Explicit DFS stack of (triangle index set, depth, parent slot).
    # parent slot: (node_idx, 0|1) to wire child links after allocation.
    all_idx = np.arange(T, dtype=np.int64)
    stack: list[tuple[np.ndarray, int, tuple[int, int] | None]] = [(all_idx, 0, None)]

    while stack:
        idx, depth, parent = stack.pop()
        me = len(node_count)
        node_min.append(tri_min[idx].min(axis=0))
        node_max.append(tri_max[idx].max(axis=0))
        node_depth.append(depth)
        if parent is not None:
            pnode, slot = parent
            a, b = node_children[pnode]
            node_children[pnode] = (me, b) if slot == 0 else (a, me)

        n = idx.shape[0]
        if n <= max_leaf_tris:
            node_first.append(perm_offset)
            node_count.append(n)
            node_children.append((-1, -1))
            perm_chunks.append(idx)
            perm_offset += n
            if progress and (perm_offset * 100) // T != ((perm_offset - n) * 100) // T:
                # Reference-style carriage-return percent bar
                # (boundingBoxes.pyx:64-65): percent of triangles placed
                # into finished leaves, monotonic over the DFS.
                print(f"\r{round(perm_offset / T * 100, 2)}%...",
                      end="", flush=True)
            continue

        cent = centroids[idx]
        extent = cent.max(axis=0) - cent.min(axis=0)
        axis = int(np.argmax(extent))
        mean = cent[:, axis].mean()
        mask = cent[:, axis] <= mean
        left, right = idx[mask], idx[~mask]
        if left.size == 0 or right.size == 0:
            # Degenerate (identical centroids on the axis): even index split.
            half = n // 2
            left, right = idx[:half], idx[half:]

        node_first.append(-1)
        node_count.append(0)
        node_children.append((0, 0))  # patched when children pop
        # Push right first so left is visited first (preorder: left = me + 1).
        stack.append((right, depth + 1, (me, 1)))
        stack.append((left, depth + 1, (me, 0)))

    if progress:
        print("")

    N = len(node_count)
    # Second pass: miss links. miss[root] = N; for internal node i with
    # children (l, r): miss[l] = r, miss[r] = miss[i].
    miss = np.full(N, N, dtype=np.int32)
    order = np.argsort(node_depth, kind="stable")  # parents before children
    for i in order:
        l, r = node_children[i]
        if l != -1:
            miss[l] = r
            miss[r] = miss[i]

    return BVH(
        node_min=np.asarray(node_min, dtype=np.float32),
        node_max=np.asarray(node_max, dtype=np.float32),
        node_miss=miss,
        node_first=np.asarray(node_first, dtype=np.int32),
        node_count=np.asarray(node_count, dtype=np.int32),
        perm=np.concatenate(perm_chunks),
        depth=int(max(node_depth)),
    )


def validate_bvh(bvh: BVH, v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, max_leaf_tris: int):
    """Check structural invariants; raises AssertionError on violation.

    Invariants (the test-pyramid items from SURVEY.md section 4): every
    triangle appears in exactly one leaf; every leaf AABB contains its
    triangles; leaf sizes are in (0, max_leaf_tris]; miss links are
    monotonically forward; DFS-preorder hit links (i + 1) stay in range.
    """
    N = bvh.num_nodes
    T = v0.shape[0]
    assert sorted(bvh.perm.tolist()) == list(range(T)), "perm is not a permutation"

    leaves = bvh.node_count > 0
    counts = bvh.node_count[leaves]
    assert counts.min() >= 1 and counts.max() <= max_leaf_tris

    covered = np.zeros(T, dtype=bool)
    for i in np.nonzero(leaves)[0]:
        first, cnt = int(bvh.node_first[i]), int(bvh.node_count[i])
        tris = bvh.perm[first : first + cnt]
        assert not covered[tris].any(), "triangle in two leaves"
        covered[tris] = True
        for arr in (v0, v1, v2):
            pts = arr[tris]
            assert (pts >= bvh.node_min[i] - 1e-4).all()
            assert (pts <= bvh.node_max[i] + 1e-4).all()
    assert covered.all(), "triangle missing from all leaves"

    idxs = np.arange(N, dtype=np.int32)
    assert (bvh.node_miss > idxs).all() and (bvh.node_miss <= N).all()
    internal = ~leaves
    assert ((idxs + 1)[internal] < N).all()
