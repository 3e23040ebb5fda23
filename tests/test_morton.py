"""Morton/coherence-key unit tests."""

import numpy as np
import jax.numpy as jnp

from opengl_raytracer_tpu.ops.morton import _spread3, morton3d, ray_sort_keys


def scalar_spread3(x: int) -> int:
    out = 0
    for i in range(10):
        out |= ((x >> i) & 1) << (3 * i)
    return out


def test_spread3_matches_scalar():
    xs = np.array([0, 1, 2, 3, 5, 171, 341, 511, 1023], dtype=np.uint32)
    got = np.asarray(_spread3(jnp.asarray(xs)))
    want = np.array([scalar_spread3(int(x)) for x in xs], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_morton_interleave():
    q = jnp.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1], [3, 3, 3]], dtype=jnp.uint32)
    got = np.asarray(morton3d(q))
    # bit order: x at 3i, y at 3i+1, z at 3i+2
    np.testing.assert_array_equal(got, [1, 2, 4, 0b111111])


def test_keys_direction_major_and_dead_rays():
    lo = jnp.zeros(3)
    hi = jnp.ones(3) * 10.0
    o = jnp.asarray([[1.0, 1, 1], [9.0, 9, 9], [1.0, 1, 1]])
    d = jnp.asarray([[1.0, 0.1, 0.1], [1.0, 0.1, 0.1], [-1.0, -0.1, -0.1]])
    k = np.asarray(ray_sort_keys(o, d, lo, hi))
    # same direction bin: near origins sort adjacent, far ones later
    assert k[0] < k[1]
    # opposite direction dominates any positional difference
    assert abs(int(k[2]) - int(k[0])) > abs(int(k[1]) - int(k[0]))
    # dead rays get the max key
    ka = np.asarray(ray_sort_keys(o, d, lo, hi,
                                  alive=jnp.asarray([True, True, False])))
    assert ka[2] == 0xFFFFFFFF and ka[0] == k[0]


def test_profiling_utils():
    from opengl_raytracer_tpu.utils.profiling import FrameStats, timer

    res = {}
    with timer("x", sync_on=jnp.ones(3), results=res):
        pass
    assert res["x"] >= 0
    fs = FrameStats()
    fs.tick()
    assert "Fps" in fs.caption(1, "1s")
