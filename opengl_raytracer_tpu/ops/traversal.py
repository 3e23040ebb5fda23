"""Vectorized BVH traversal — the data-parallel rewrite of the reference's
divergent per-fragment stack walk (reference: fragment.glsl:246-307).

Two strategies over the same DFS-preorder-with-miss-links node layout
(ops/bvh.py):

:func:`raycast_bvh` — per-ray stackless walk: every ray carries one node
index through a ``lax.while_loop``.  Simple and exact, but each iteration
gathers node/triangle data *per ray* from HBM and runs until the most
divergent ray finishes — kept as the reference implementation and for small
ray counts.

:func:`raycast_packet` — **packet traversal**, the production path.  Rays
are grouped into packets of 128 (the renderer feeds 8x16 pixel blocks, so
packets are spatially coherent).  Each packet shares ONE node pointer: a
node is visited when *any* live ray in the packet hits its AABB ahead of
that ray's current nearest hit.  Consequences:

* control state is per-packet (P = R/128 elements), so the node gathers
  shrink by 128x and the while-loop divergence cost is paid per packet,
  not per ray;
* the slab test runs dense ``[P, 128]``;
* traversal is two-phase: an inner loop advances node pointers (slab tests
  only) until every packet rests at a leaf or is done, then one dense leaf
  phase runs ``[P, 128]`` Möller–Trumbore tests against the packet's leaf
  triangles (one scalar triangle id per packet per slot -> tiny gathers,
  dense math).  This avoids paying triangle tests on every node step,
  which is what sinks the naive vectorization.

Per-ray pruning stays exact: a ray only accepts hits closer than its
current best (the packet may *visit* nodes some member ray would have
skipped — harmless extra work, never a wrong image).  Dead rays (mask
``active=False``) get ``best_t = -inf`` so they can neither trigger node
visits nor accept hits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from opengl_raytracer_tpu.ops.intersect import (
    BIG,
    EPS,
    Nearest,
    init_nearest,
    mt_single,
    slab_test,
)

PACKET = 128


def raycast_bvh(scene, origin, direction, active=None, max_leaf_tris: int = 4) -> Nearest:
    """Nearest hit for rays (R,3) via per-ray stackless traversal."""
    R = origin.shape[0]
    N = scene.node_miss.shape[0]
    inv_dir = 1.0 / direction

    near0 = init_nearest(R)
    if active is not None:
        near0 = near0._replace(t=jnp.where(active, near0.t, -BIG))

    def cond(state):
        node, _ = state
        return jnp.any(node < N)

    def body(state):
        node, near = state
        alive = node < N
        nidx = jnp.minimum(node, N - 1)

        bmin = scene.node_min[nidx]
        bmax = scene.node_max[nidx]
        t_near = slab_test(origin, inv_dir, bmin, bmax)
        # Visit iff the box is hit ahead of the current nearest hit
        # (fragment.glsl:261-262).
        box_hit = alive & (t_near >= 0.0) & (t_near <= near.t)

        count = scene.node_count[nidx]
        first = scene.node_first[nidx]
        is_leaf = count > 0
        leaf_hit = box_hit & is_leaf

        for l in range(max_leaf_tris):
            tri_ok = leaf_hit & (l < count)
            tri = jnp.where(tri_ok, first + l, 0)
            valid, t, u, v = mt_single(
                origin,
                direction,
                scene.v0[tri],
                scene.e1[tri],
                scene.e2[tri],
                scene.face[tri],
            )
            upd = tri_ok & valid & (t < near.t)
            near = Nearest(
                t=jnp.where(upd, t, near.t),
                tri=jnp.where(upd, tri, near.tri),
                u=jnp.where(upd, u, near.u),
                v=jnp.where(upd, v, near.v),
            )

        nxt = jnp.where(box_hit & ~is_leaf, node + 1, scene.node_miss[nidx])
        node = jnp.where(alive, nxt, node)
        return node, near

    node0 = jnp.zeros((R,), jnp.int32)
    _, near = jax.lax.while_loop(cond, body, (node0, near0))
    if active is not None:
        near = near._replace(t=jnp.where(active, near.t, BIG))
    return near


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def raycast_packet(scene, origin, direction, active=None,
                   max_leaf_tris: int = 4, packet: int = PACKET) -> Nearest:
    """Nearest hit for rays (R,3) via coherent packet traversal.

    R must be a multiple of ``packet`` (the renderer guarantees this and
    orders rays into spatially coherent blocks).
    """
    R = origin.shape[0]
    if R % packet:
        raise ValueError(f"ray count {R} not a multiple of packet {packet}")
    P = R // packet
    N = scene.node_miss.shape[0]

    o = origin.reshape(P, packet, 3)
    d = direction.reshape(P, packet, 3)
    inv_d = 1.0 / d

    best_t0 = jnp.full((P, packet), BIG, jnp.float32)
    if active is not None:
        # Dead rays can neither open nodes nor accept hits.
        best_t0 = jnp.where(active.reshape(P, packet), best_t0, -BIG)
    near0 = Nearest(
        t=best_t0,
        tri=jnp.zeros((P, packet), jnp.int32),
        u=jnp.zeros((P, packet), jnp.float32),
        v=jnp.zeros((P, packet), jnp.float32),
    )

    # Packets with no live ray start at the done sentinel.
    if active is not None:
        node0 = jnp.where(active.reshape(P, packet).any(axis=1), 0, N).astype(jnp.int32)
    else:
        node0 = jnp.zeros((P,), jnp.int32)
    pending0 = jnp.zeros((P,), bool)

    def outer_cond(state):
        node, pending, _ = state
        return jnp.any(node < N)

    def outer_body(state):
        node, pending, near = state

        # --- phase 1: advance node pointers until each packet rests at a
        # leaf it must process (pending) or falls off the tree.
        def adv_cond(s):
            node, pending, _ = s
            return jnp.any((node < N) & ~pending)

        def adv_body(s):
            node, pending, near = s
            moving = (node < N) & ~pending
            nidx = jnp.minimum(node, N - 1)

            bmin = scene.node_min[nidx][:, None, :]  # [P,1,3]
            bmax = scene.node_max[nidx][:, None, :]
            t_near = slab_test(o, inv_d, bmin, bmax)  # [P,packet]
            ray_hit = (t_near >= 0.0) & (t_near <= near.t)
            any_hit = ray_hit.any(axis=1)  # [P]

            is_leaf = scene.node_count[nidx] > 0
            miss = scene.node_miss[nidx]

            pending = jnp.where(moving & any_hit & is_leaf, True, pending)
            nxt = jnp.where(any_hit & ~is_leaf, node + 1, miss)
            node = jnp.where(moving & ~(any_hit & is_leaf), nxt, node)
            return node, pending, near

        node, pending, near = jax.lax.while_loop(
            adv_cond, adv_body, (node, pending, near)
        )

        # --- phase 2: dense leaf processing for pending packets.
        nidx = jnp.minimum(node, N - 1)
        first = scene.node_first[nidx]
        count = scene.node_count[nidx]
        for l in range(max_leaf_tris):
            slot_ok = pending & (l < count)  # [P]
            tri = jnp.where(slot_ok, first + l, 0)  # [P]
            # One triangle per packet, broadcast over its 128 rays.
            v0 = scene.v0[tri][:, None, :]
            e1 = scene.e1[tri][:, None, :]
            e2 = scene.e2[tri][:, None, :]
            face = scene.face[tri][:, None, :]

            det = _dot(d, face)
            inv_det = 1.0 / det
            vro = o - v0
            t = -_dot(vro, face) * inv_det
            perp = jnp.cross(vro, d)
            u = -_dot(e2, perp) * inv_det
            v = _dot(e1, perp) * inv_det
            valid = (
                (jnp.abs(det) >= EPS)
                & (t > EPS)
                & (u >= 0.0)
                & (v >= 0.0)
                & ((u + v) <= 1.0)
            )
            upd = slot_ok[:, None] & valid & (t < near.t)
            near = Nearest(
                t=jnp.where(upd, t, near.t),
                tri=jnp.where(upd, jnp.broadcast_to(tri[:, None], t.shape), near.tri),
                u=jnp.where(upd, u, near.u),
                v=jnp.where(upd, v, near.v),
            )

        node = jnp.where(pending, scene.node_miss[nidx], node)
        pending = jnp.zeros_like(pending)
        return node, pending, near

    _, _, near = jax.lax.while_loop(outer_cond, outer_body, (node0, pending0, near0))

    flat = Nearest(
        t=near.t.reshape(R),
        tri=near.tri.reshape(R),
        u=near.u.reshape(R),
        v=near.v.reshape(R),
    )
    if active is not None:
        flat = flat._replace(t=jnp.where(active, flat.t, BIG))
    return flat
