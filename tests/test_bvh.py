"""BVH builder invariants (the test-pyramid items from SURVEY.md section 4):
every triangle in exactly one leaf, AABB containment, leaf-size bounds,
forward-only miss links — on random soups, degenerate inputs, and a real
mesh."""

import numpy as np
import pytest

from opengl_raytracer_tpu.ops.bvh import build_bvh, validate_bvh


def random_tris(n, seed=0, spread=10.0):
    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, size=(n, 1, 3))
    tri = base + r.uniform(-0.5, 0.5, size=(n, 3, 3))
    tri = tri.astype(np.float32)
    return tri[:, 0], tri[:, 1], tri[:, 2]


@pytest.mark.parametrize("n", [1, 2, 5, 33, 1000])
@pytest.mark.parametrize("leaf", [1, 4, 8])
def test_invariants_random(n, leaf):
    v0, v1, v2 = random_tris(n, seed=n + leaf)
    bvh = build_bvh(v0, v1, v2, max_leaf_tris=leaf)
    validate_bvh(bvh, v0, v1, v2, leaf)


def test_identical_centroids():
    # All triangles identical: mean split degenerates; even split must kick in
    v0 = np.zeros((64, 3), np.float32)
    v1 = np.tile(np.array([[1, 0, 0]], np.float32), (64, 1))
    v2 = np.tile(np.array([[0, 1, 0]], np.float32), (64, 1))
    bvh = build_bvh(v0, v1, v2, max_leaf_tris=4)
    validate_bvh(bvh, v0, v1, v2, 4)


def test_root_covers_everything():
    v0, v1, v2 = random_tris(500, seed=3)
    bvh = build_bvh(v0, v1, v2, max_leaf_tris=4)
    lo = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
    hi = np.maximum(np.maximum(v0, v1), v2).max(axis=0)
    np.testing.assert_allclose(bvh.node_min[0], lo, atol=1e-5)
    np.testing.assert_allclose(bvh.node_max[0], hi, atol=1e-5)


def test_sphere_mesh():
    from opengl_raytracer_tpu.models.procedural import uv_sphere

    m = uv_sphere([0, 0, 0], [0, 0, 0], scale=2.0)
    v = m.pos.reshape(-1, 3, 3)
    bvh = build_bvh(v[:, 0], v[:, 1], v[:, 2], max_leaf_tris=4)
    validate_bvh(bvh, v[:, 0], v[:, 1], v[:, 2], 4)
    assert bvh.depth < 40
