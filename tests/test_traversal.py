"""Traversal choice and agreement: the one selector shared by Renderer and
ShardedRenderer, the traversal names the config accepts, and nearest hits
of packet, brute force and the per-ray BVH walk on a reduced generated
scene."""

import jax.numpy as jnp
import numpy as np
import pytest

from opengl_raytracer_tpu.models import procedural
from opengl_raytracer_tpu.models.rect import Rect
from opengl_raytracer_tpu.models.scene import Scene
from opengl_raytracer_tpu.models.trisoup import Triangles
from opengl_raytracer_tpu.ops.intersect import BIG, raycast_brute
from opengl_raytracer_tpu.ops.traversal import raycast_bvh, raycast_packet
from opengl_raytracer_tpu.renderer import (effective_max_leaf, select_traversal)
from opengl_raytracer_tpu.utils.config import RenderConfig


def box_scene(**kw):
    return Scene([Rect([4, 4, 0.1], [0, 0, -2], [0, 0, 0], color=[1, 1, 1])],
                 **kw)


def soup_scene(n, **kw):
    rng = np.random.default_rng(0)
    tri = rng.uniform(-5, 5, size=(n, 3, 3)).astype(np.float32)
    return Scene([Triangles(tri, color=(1, 1, 1))], **kw)


def reduced_scene():
    """The default scene's layout with coarse generated meshes (~1k
    triangles), small enough for brute force on the CPU."""
    return Scene([
        procedural.blob([0, -1, 0], [0, 0, 0], [0.9, 0.9, 0.8], roughness=1,
                        scale=(2.0, 2.5, 2.0), segments=24, rings=14),
        procedural.uv_sphere([3, -1, 2], [0, 0, 0], [1, 1, 1], scale=1.2,
                             segments=16, rings=8),
        Rect([12, 0.2, 12], [0, -3.6, 0], [0, 0, 0], [0.3, 0.8, 0.3],
             roughness=1),
    ], max_leaf_tris=8)


@pytest.mark.parametrize("make,traversal,expected", [
    (lambda: box_scene(), "auto", "brute"),            # 12 tris <= 128
    (lambda: soup_scene(129), "auto", "packet"),       # just over 128
    (lambda: soup_scene(1500, build_bvh=False), "auto", "brute"),  # giant leaf
    (lambda: soup_scene(200), "bvh", "bvh"),
    (lambda: box_scene(), "packet", "packet"),
])
def test_select_traversal(make, traversal, expected):
    scene = make().send()
    cfg = RenderConfig(width=16, height=16, traversal=traversal)
    assert select_traversal(scene, cfg) == expected


def test_select_traversal_refuses_giant_leaf():
    scene = soup_scene(1500, build_bvh=False).send()
    assert effective_max_leaf(scene, RenderConfig()) == 1500
    with pytest.raises(ValueError, match="1024"):
        select_traversal(scene, RenderConfig(traversal="packet"))


@pytest.mark.parametrize("name", ["pallas", "pallas2", "subblock", ""])
def test_removed_traversals_rejected(name):
    with pytest.raises(ValueError, match="unknown traversal"):
        RenderConfig(traversal=name)


def test_cli_traversal_choices():
    from opengl_raytracer_tpu.__main__ import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(["--traversal", "pallas2"])
    assert build_parser().parse_args(["--traversal", "bvh"]).traversal == "bvh"


def random_rays(scene, n, seed):
    """Rays from random points around the scene toward random points on
    its triangles, plus some that leave it entirely."""
    rng = np.random.default_rng(seed)
    v0 = np.asarray(scene.v0)[: scene.num_tris]
    targets = v0[rng.integers(0, v0.shape[0], n)] + rng.normal(0, 0.3, (n, 3))
    origins = rng.uniform(-7, 7, (n, 3))
    d = targets - origins
    d[: n // 8] = rng.normal(size=(n // 8, 3))  # mostly misses
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(origins, jnp.float32), jnp.asarray(d, jnp.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_packet_brute_bvh_nearest_agree(seed):
    scene = reduced_scene().send()
    leaf = effective_max_leaf(scene, RenderConfig())
    o, d = random_rays(scene, 1024, seed)
    active = jnp.asarray(np.random.default_rng(seed).random(1024) < 0.9)
    near = {
        "brute": raycast_brute(scene, o, d, active),
        "bvh": raycast_bvh(scene, o, d, active, max_leaf_tris=leaf),
        "packet": raycast_packet(scene, o, d, active, max_leaf_tris=leaf),
    }
    act = np.asarray(active)
    ref = near["brute"]
    hit = np.asarray(ref.t) < BIG
    assert 0.3 < hit[act].mean() < 0.99
    assert (np.asarray(ref.t)[~act] == BIG).all()
    for name in ("bvh", "packet"):
        n = near[name]
        np.testing.assert_array_equal(np.asarray(n.t) < BIG, hit, err_msg=name)
        np.testing.assert_array_equal(np.asarray(n.tri)[hit],
                                      np.asarray(ref.tri)[hit], err_msg=name)
        np.testing.assert_allclose(np.asarray(n.t)[hit], np.asarray(ref.t)[hit],
                                   rtol=1e-6, err_msg=name)


def test_brute_short_hits_keep_precision():
    """A bounce ray leaving a surface far from the origin hits its
    neighbour at t << |o|; the brute-force winner's t is recomputed per
    ray, so it keeps float32 precision there (the matmul form alone kept
    ~2 digits)."""
    tri = np.array([[[30, -1, -1], [30, 1, -1], [30, 0, 1]]], np.float32)
    scene = Scene([Triangles(tri, color=(1, 1, 1))], build_bvh=False).send()
    t_true = np.array([2e-4, 5e-4, 1e-3, 3e-3], np.float64)
    d = np.array([[1.0, 0.01, 0.02]] * 4)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.array([30.0, 0.0, 0.0]) - d * t_true[:, None]
    o32, d32 = o.astype(np.float32), d.astype(np.float32)
    near = raycast_brute(scene, jnp.asarray(o32), jnp.asarray(d32))
    # float64 distance for the float32 rays as given
    t_ref = (30.0 - o32[:, 0].astype(np.float64)) / d32[:, 0]
    np.testing.assert_allclose(t_ref, t_true, rtol=0.05)
    np.testing.assert_allclose(np.asarray(near.t), t_ref, rtol=1e-4)
