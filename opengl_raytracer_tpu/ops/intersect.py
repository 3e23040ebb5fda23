"""Batched ray-primitive intersection tests.

Rebuilds the reference's device intersectors as vectorized JAX math:

* Möller–Trumbore-style triangle test in the exact plane-determinant form of
  the shader (reference: fragment.glsl:106-177), with ``EPS = 1e-6``
  parallel/self-hit rejection;
* vectorized slab AABB test returning the clamped entry distance or -1
  (fragment.glsl:181-204).

Two triangle-test shapes are provided:

* :func:`mt_single` — per-ray gathered triangles ((R,3) against (R,3) data),
  used by the BVH leaf loop; keeps the reference's exact operation order.
* :func:`raycast_brute` — all rays against all triangles via an algebraic
  rearrangement into ``[R,3] @ [3,C]`` matmuls (using the triple-product
  identity ``e·((o-v0)×d) = e·(o×d) - d·(e×v0)``), so the brute-force sweep
  runs as dense matrix products with **no** ``[R,C,3]`` intermediates.  This
  is the correctness oracle and the fast path for small scenes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

EPS = np.float32(1e-6)
BIG = np.float32(1e30)


class Hit(NamedTuple):
    """Per-ray nearest-hit record (the shader's ``Hit`` struct,
    fragment.glsl:68-81, flattened to SoA)."""

    did_hit: jnp.ndarray  # (R,) bool
    t: jnp.ndarray  # (R,) float32
    point: jnp.ndarray  # (R, 3)
    normal: jnp.ndarray  # (R, 3)
    color: jnp.ndarray  # (R, 3)
    emission: jnp.ndarray  # (R,)
    emission_color: jnp.ndarray  # (R, 3)
    roughness: jnp.ndarray  # (R,)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def mt_single(origin, direction, v0, e1, e2, face):
    """Möller–Trumbore for per-ray triangle data; all args (R, 3).

    Returns (valid, t, u, v) with the reference's rejection rules
    (fragment.glsl:110-143): near-parallel (|det| < EPS), behind-origin /
    self-hit (t <= EPS), and outside barycentric bounds.
    """
    det = _dot(direction, face)
    inv_det = 1.0 / det
    vro = origin - v0
    t = -_dot(vro, face) * inv_det
    perp = jnp.cross(vro, direction)
    u = -_dot(e2, perp) * inv_det
    v = _dot(e1, perp) * inv_det
    valid = (
        (jnp.abs(det) >= EPS)
        & (t > EPS)
        & (u >= 0.0)
        & (v >= 0.0)
        & ((u + v) <= 1.0)
    )
    return valid, t, u, v


def slab_test(origin, inv_dir, box_min, box_max):
    """Slab AABB test (fragment.glsl:181-204).

    Returns the entry distance, clamped to 0 when the origin is inside the
    box, or -1 on miss / fully-behind.  Broadcasts over leading dims.
    """
    t_min = (box_min - origin) * inv_dir
    t_max = (box_max - origin) * inv_dir
    t1 = jnp.minimum(t_min, t_max)
    t2 = jnp.maximum(t_min, t_max)
    dst_near = jnp.max(t1, axis=-1)
    dst_far = jnp.min(t2, axis=-1)
    hit = (dst_far >= dst_near) & (dst_far >= 0.0)
    return jnp.where(hit, jnp.maximum(dst_near, 0.0), -1.0)


class Nearest(NamedTuple):
    """Carry for nearest-hit reduction: distance, triangle id (in permuted
    order), and that triangle's barycentrics."""

    t: jnp.ndarray  # (R,)
    tri: jnp.ndarray  # (R,) int32
    u: jnp.ndarray  # (R,)
    v: jnp.ndarray  # (R,)


def init_nearest(num_rays: int) -> Nearest:
    return Nearest(
        t=jnp.full((num_rays,), BIG, jnp.float32),
        tri=jnp.zeros((num_rays,), jnp.int32),
        u=jnp.zeros((num_rays,), jnp.float32),
        v=jnp.zeros((num_rays,), jnp.float32),
    )


def raycast_brute(scene, origin, direction, active=None,
                  tri_chunk: int = 2048) -> Nearest:
    """Nearest hit by a dense sweep over all triangles.

    Matmul form: for a triangle chunk with vertices v0 and edges e1/e2 and
    precomputable per-triangle vectors, every per-(ray, tri) quantity is a
    ``[R,3] @ [3,C]`` contraction:

        det = d . face
        t   = (v0.face - o.face) / det
        u   = -((o x d).e2 - d.(e2 x v0)) / det
        v   =  ((o x d).e1 - d.(e1 x v0)) / det

    The scan over triangle chunks carries the running nearest hit, matching
    the shader's strict ``h.t < closestT`` update rule (fragment.glsl:275).
    The winner's t and barycentrics are then recomputed per ray in the
    shader's own operation order (:func:`mt_single`): the matmul form's
    ``v0.face - o.face`` cancels catastrophically for short hits (a bounce
    ray leaving a surface, t << |o|), where it keeps only ~2 digits of t.
    Where the per-ray test rejects the winner, the matmul form's values
    stand, so a hit always has t > EPS.
    """
    R = origin.shape[0]
    T = scene.v0.shape[0]
    C = min(tri_chunk, T)
    n_chunks = -(-T // C)
    pad = n_chunks * C - T

    def prep(arr):
        if pad:
            arr = jnp.concatenate([arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)], 0)
        return arr.reshape(n_chunks, C, *arr.shape[1:])

    v0s, e1s, e2s, faces = map(prep, (scene.v0, scene.e1, scene.e2, scene.face))
    base = jnp.arange(n_chunks, dtype=jnp.int32) * C

    cross_od = jnp.cross(origin, direction)  # (R, 3)

    # Full-f32 contractions: the default matmul precision (bf16 passes, or
    # TF32 on a GPU) keeps ~3 decimal digits, which corrupts barycentric
    # accept/reject decisions.
    def mm(a, b):
        return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

    def body(carry: Nearest, chunk):
        v0, e1, e2, face, base_idx = chunk
        d0 = _dot(v0, face)  # (C,)
        q1 = jnp.cross(e1, v0)  # (C, 3)
        q2 = jnp.cross(e2, v0)

        det = mm(direction, face.T)  # (R, C)
        inv_det = 1.0 / det
        t = (d0[None, :] - mm(origin, face.T)) * inv_det
        u = -(mm(cross_od, e2.T) - mm(direction, q2.T)) * inv_det
        v = (mm(cross_od, e1.T) - mm(direction, q1.T)) * inv_det

        valid = (
            (jnp.abs(det) >= EPS)
            & (t > EPS)
            & (u >= 0.0)
            & (v >= 0.0)
            & ((u + v) <= 1.0)
        )
        ts = jnp.where(valid, t, BIG)
        arg = jnp.argmin(ts, axis=1)
        best_t = jnp.take_along_axis(ts, arg[:, None], 1)[:, 0]
        best_u = jnp.take_along_axis(u, arg[:, None], 1)[:, 0]
        best_v = jnp.take_along_axis(v, arg[:, None], 1)[:, 0]

        better = best_t < carry.t
        return Nearest(
            t=jnp.where(better, best_t, carry.t),
            tri=jnp.where(better, base_idx + arg.astype(jnp.int32), carry.tri),
            u=jnp.where(better, best_u, carry.u),
            v=jnp.where(better, best_v, carry.v),
        ), None

    def run_scan(_):
        carry, _ = jax.lax.scan(
            body, init_nearest(R), (v0s, e1s, e2s, faces, base))
        return carry

    def refine(near: Nearest) -> Nearest:
        tri = near.tri
        valid, t, u, v = mt_single(origin, direction, scene.v0[tri],
                                   scene.e1[tri], scene.e2[tri], scene.face[tri])
        # A winner the per-ray test rejects (an edge or t <= EPS decided
        # the other way) keeps the matmul form's values, which passed.
        ok = (near.t < BIG) & valid
        return Nearest(t=jnp.where(ok, t, near.t), tri=tri,
                       u=jnp.where(ok, u, near.u),
                       v=jnp.where(ok, v, near.v))

    if active is None:
        carry = refine(run_scan(None))
    else:
        # Dead-ray early-out: a chunk whose rays are ALL terminated skips
        # the entire triangle sweep (the brute path's analog of the
        # traversal kernels' best_t = -inf gating).  Mixed chunks still
        # sweep densely — rows of a matmul cannot be skipped.
        carry = jax.lax.cond(jnp.any(active), lambda _: refine(run_scan(_)),
                             lambda _: init_nearest(R), None)
        carry = carry._replace(t=jnp.where(active, carry.t, BIG))
    return carry


class HitSoA(NamedTuple):
    """SoA nearest-hit record: vec3 fields are 3-tuples of (R,) columns.

    The AoS :class:`Hit` keeps (R, 3) arrays, whose 3-wide minor dimension
    makes every elementwise consumer strided; column tuples keep every
    consumer op dense and fusible."""

    did_hit: jnp.ndarray  # (R,) bool
    t: jnp.ndarray  # (R,)
    point: tuple  # 3 x (R,)
    normal: tuple  # 3 x (R,)
    color: tuple  # 3 x (R,)
    emission: jnp.ndarray  # (R,)
    emission_color: tuple  # 3 x (R,)
    roughness: jnp.ndarray  # (R,)


def finalize_hit_soa(scene, o3, d3, nearest: Nearest) -> HitSoA:
    """Resolve the nearest-hit record into the shader's Hit fields
    (fragment.glsl:146-176): hit point, smooth barycentric normal with
    degenerate fallback to the geometric normal, flip-to-face-ray, and
    material gather.  ``o3``/``d3`` are 3-tuples of (R,) columns."""
    did_hit = nearest.t < BIG

    point = tuple(o3[a] + d3[a] * nearest.t for a in range(3))

    # ONE 24-wide row gather fetches all of the hit's shading data
    # (Scene.send packs it) instead of eight column gathers.
    abc = scene.sh_abc[nearest.tri]
    # One explicit transpose, then every material field is a dense (R,)
    # row slice — consumers fuse into few single-pass kernels instead of
    # each re-reading the row-major (R, 24) array with a 24-wide minor.
    abc_t = abc.T
    col = lambda k: abc_t[k]
    n0 = (col(0), col(1), col(2))
    n1 = (col(3), col(4), col(5))
    n2 = (col(8), col(9), col(10))
    face = (col(11), col(12), col(13))

    u, v = nearest.u, nearest.v
    w = 1.0 - u - v
    raw = tuple(n0[a] * w + n1[a] * u + n2[a] * v for a in range(3))
    raw_len = jnp.sqrt(raw[0] * raw[0] + raw[1] * raw[1] + raw[2] * raw[2])
    face_len = jnp.sqrt(
        face[0] * face[0] + face[1] * face[1] + face[2] * face[2])
    # fragment.glsl:155-160 — normalize, falling back to the geometric
    # normal when interpolation degenerates (guarded div instead of NaN).
    ok_len = raw_len > np.float32(1e-20)
    den_raw = jnp.maximum(raw_len, np.float32(1e-30))
    den_face = jnp.maximum(face_len, np.float32(1e-30))
    normal = tuple(
        jnp.where(ok_len, raw[a] / den_raw, face[a] / den_face)
        for a in range(3)
    )
    # Flip the normal against the incoming ray (fragment.glsl:163-165).
    flip = (d3[0] * normal[0] + d3[1] * normal[1]
            + d3[2] * normal[2]) > 0.0
    normal = tuple(jnp.where(flip, -normal[a], normal[a]) for a in range(3))

    return HitSoA(
        did_hit=did_hit,
        t=nearest.t,
        point=point,
        normal=normal,
        color=(col(16), col(17), col(18)),
        emission=col(6),
        emission_color=(col(19), col(20), col(21)),
        roughness=col(7),
    )


def finalize_hit(scene, origin, direction, nearest: Nearest) -> Hit:
    """AoS wrapper over :func:`finalize_hit_soa` (compatibility surface
    for tests and on-card checks; the integrator uses the SoA form
    directly)."""
    h = finalize_hit_soa(
        scene,
        tuple(origin[..., a] for a in range(3)),
        tuple(direction[..., a] for a in range(3)),
        nearest,
    )
    return Hit(
        did_hit=h.did_hit,
        t=h.t,
        point=jnp.stack(h.point, axis=-1),
        normal=jnp.stack(h.normal, axis=-1),
        color=jnp.stack(h.color, axis=-1),
        emission=h.emission,
        emission_color=jnp.stack(h.emission_color, axis=-1),
        roughness=h.roughness,
    )
