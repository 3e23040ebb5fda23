"""Ray-coherence sort keys (Morton/Z-order + direction octant).

The packet and Pallas traversals share one node pointer per ray block, so
their cost is the union of the block members' node visits.  Primary rays
arrive coherent (8x16 screen packets), but after a bounce the block members
scatter across the scene and the union approaches the whole tree.  The
wavefront fix: before each bounce's raycast, sort rays by a spatial key —

    key = morton9(origin quantized to the scene AABB) << 3 | octant(dir)

so consecutive 1024-ray blocks start near each other and fly the same way.
Dead rays get the maximal key: they cluster into all-dead tail blocks whose
traversal exits after a single root test.

Reordering is exact: per-ray math is order-independent and each ray carries
its RNG state; results are bit-identical to unsorted traversal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U = np.uint32


def _spread3(x: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of x so bit i lands at position 3i
    (standard Morton magic numbers, 32-bit)."""
    x = x & _U(0x3FF)
    x = (x | (x << _U(16))) & _U(0x030000FF)
    x = (x | (x << _U(8))) & _U(0x0300F00F)
    x = (x | (x << _U(4))) & _U(0x030C30C3)
    x = (x | (x << _U(2))) & _U(0x09249249)
    return x


def morton3d(q: jnp.ndarray) -> jnp.ndarray:
    """Interleave (..., 3) uint32 coordinates (low 10 bits each)."""
    return (
        _spread3(q[..., 0])
        | (_spread3(q[..., 1]) << _U(1))
        | (_spread3(q[..., 2]) << _U(2))
    )


def ray_sort_keys_soa(o3, d3, lo, hi, alive=None) -> jnp.ndarray:
    """SoA form of :func:`ray_sort_keys`: ``o3``/``d3`` are 3-tuples of
    (R,) component columns and ``lo``/``hi`` are (3,) vectors.

    Column-wise math keeps the whole key computation on dense (R,)
    arrays — the (R, 3) AoS form makes every op strided over a 3-wide
    minor dimension or needs layout copies around it.
    """
    ext = [jnp.maximum(hi[a] - lo[a], np.float32(1e-6)) for a in range(3)]
    q = [
        jnp.clip((o3[a] - lo[a]) / ext[a] * np.float32(512.0), 0.0, 511.0)
        .astype(jnp.uint32)
        for a in range(3)
    ]
    dq = [
        jnp.clip((d3[a] * 0.5 + 0.5) * 4.0, 0.0, 3.0).astype(jnp.uint32)
        for a in range(3)
    ]
    dir6 = (dq[0] << _U(4)) | (dq[1] << _U(2)) | dq[2]
    dq4 = [
        jnp.clip((d3[a] * 0.5 + 0.5) * 16.0, 0.0, 15.0).astype(jnp.uint32)
        for a in (1, 2)
    ]
    dfine6 = ((dq4[0] & _U(3)) << _U(4)) | dq4[1]
    m = _spread3(q[0]) | (_spread3(q[1]) << _U(1)) | (_spread3(q[2]) << _U(2))
    key = ((dir6 << _U(26)) | ((m >> _U(15)) << _U(14))
           | (dfine6 << _U(8)) | ((m >> _U(7)) & _U(0xFF)))
    # Reserve the dead-ray sentinel (see ray_sort_keys).
    key = jnp.minimum(key, _U(0xFFFFFFFE))
    if alive is not None:
        key = jnp.where(alive, key, _U(0xFFFFFFFF))
    return key


def ray_sort_keys(origin, direction, lo, hi, alive=None) -> jnp.ndarray:
    """uint32 coherence keys for rays: quantized direction major (2 bits
    per axis), origin Morton minor (24 bits).

    Direction-major ordering measures ~2.3x faster bounce traversal than
    position-major on the dragon scene: diffuse bounces from one surface
    region spray over the whole hemisphere, so blocks formed by position
    alone still traverse the union of everything visible from that region.
    2 bits/axis beats both plain sign bits (too coarse within an octant)
    and 3 bits/axis (fragments spatial locality); the top bit of each
    2-bit field is the sign, so sorted blocks stay octant-pure for the
    traversal's precomputed child ordering.

    Within a direction cell, the minor bits interleave COARSE position
    (top 12 Morton bits, 16^3 cells) above FINE direction (2 more bits of
    y/z plus 4 of z at 16 levels/axis) above fine position: packets from
    one scene region flying one way agree on both the entry subtree and
    the frustum, so 128-ray packets open fewer nodes than with a plain
    direction|position key.
    """
    return ray_sort_keys_soa(
        tuple(origin[..., a] for a in range(3)),
        tuple(direction[..., a] for a in range(3)),
        lo, hi, alive,
    )
