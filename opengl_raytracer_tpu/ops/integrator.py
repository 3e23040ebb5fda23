"""Monte-Carlo path integrator: scatter model + bounce loop + sample loop.

Faithful vectorization of the shader's path logic:

* ``diffuse()`` (reference: fragment.glsl:220-232): in lambertian mode the
  scatter direction is ``normalize(normal + xi)`` with xi uniform in
  [-1,1]^3 (a cosine-weighted approximation); otherwise the random vector is
  sign-flipped into the hemisphere and normalized.
* ``lerp()`` (fragment.glsl:234-240) blends the normalized diffuse and
  mirror-reflection directions by ``1 - roughness`` and renormalizes:
  roughness 1 -> pure diffuse, 0 -> mirror.
``raycast_fn(o3, d3, alive)`` receives the ray components as 3-tuples of
(R,) columns plus the live-ray mask so traversal can skip work for
terminated paths (renderer.make_raycast_fn).

* the bounce loop (fragment.glsl:309-350) adds ``emission_color * emission *
  rayColor`` on every hit (doubled in lambertian mode, fragment.glsl:329-331),
  multiplies the throughput by the surface color, offsets the next origin by
  ``normal * 1e-4``, terminates on ANY emissive hit, and on miss adds the
  constant sky then stops.  The per-fragment ``break`` statements become an
  ``alive`` mask; dead rays contribute exactly their frozen light.
* ``trace()`` (fragment.glsl:352-366) averages ``rays_per_pixel`` fully
  independent restarts of the same primary ray, with the RNG state carried
  sequentially across samples exactly like the shader's single ``seed``.

The bounce loop is UNROLLED (the bounce count is a static config int):
dead rays carry an ``alive`` mask — the vector analog of the shader's
breaks — and contribute exactly their frozen light to every later bounce.

ALL per-ray state is SoA — vec3 quantities travel as 3-tuples of (R,)
columns, never (R, 3) arrays.  Columns keep every elementwise op dense and
let XLA fuse each bounce's shading/update math into a few single-pass
kernels.  The multi-operand reorder sort already carries scalar columns,
so SoA also saves its stack/unstack copies.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from opengl_raytracer_tpu.ops import rng
from opengl_raytracer_tpu.ops.intersect import finalize_hit_soa


def _as_soa(x):
    """(R, 3) array -> 3-tuple of (R,) columns; tuples pass through."""
    if isinstance(x, (tuple, list)):
        return tuple(x)
    return tuple(x[..., a] for a in range(3))


def _norm3(x, y, z):
    return jnp.sqrt(x * x + y * y + z * z)


def scatter_soa(seed, n3, d3, roughness, lambertian):
    """Next bounce direction; returns (new_seed, (dx, dy, dz)).

    Draws exactly three RNG values (the shader draws them in ``diffuse``
    before any other decision, fragment.glsl:221), computes the mirror
    direction with ``reflect``, and blends per ``lerp``.

    ``lambertian`` is a TRACED bool scalar (the reference flips a uniform,
    main.py:353-360 / fragment.glsl:16, so toggling it must not recompile);
    both scatter formulas are computed and selected per-element.
    """
    seed, x0 = rng.random_value(seed)
    seed, x1 = rng.random_value(seed)
    seed, x2 = rng.random_value(seed)
    xi = (x0, x1, x2)

    lam = jnp.asarray(lambertian, bool)
    tiny = np.float32(1e-30)

    # lambertian: normalize(normal + xi) — GLSL normalize (plain division;
    # clamp the denominator at a denormal-level tiny to keep NaNs out).
    s = tuple(n3[a] + xi[a] for a in range(3))
    s_len = jnp.maximum(_norm3(*s), tiny)
    diffuse_lam = tuple(s[a] / s_len for a in range(3))

    # hemisphere mode: sign-flip xi into the normal's hemisphere.
    d_xn = xi[0] * n3[0] + xi[1] * n3[1] + xi[2] * n3[2]
    flip = d_xn < 0.0
    xi_h = tuple(jnp.where(flip, -xi[a], xi[a]) for a in range(3))
    h_len = jnp.maximum(_norm3(*xi_h), tiny)
    diffuse_hemi = tuple(xi_h[a] / h_len for a in range(3))

    diffuse = tuple(jnp.where(lam, diffuse_lam[a], diffuse_hemi[a])
                    for a in range(3))

    # GLSL reflect(I, N) = I - 2*dot(N, I)*N (fragment.glsl:320).
    d_dn = d3[0] * n3[0] + d3[1] * n3[1] + d3[2] * n3[2]
    spec = tuple(d3[a] - 2.0 * d_dn * n3[a] for a in range(3))

    # lerp(diffuseDir, specularDir, roughness) (fragment.glsl:234-240):
    # both inputs renormalized with the ZERO-STAYS-ZERO guard, then the
    # blend renormalized unguarded.
    dif_len = _norm3(*diffuse)
    d0 = tuple(
        jnp.where(dif_len > 0.0, diffuse[a] / jnp.maximum(dif_len, tiny), 0.0)
        for a in range(3)
    )
    spec_len = _norm3(*spec)
    d1 = tuple(
        jnp.where(spec_len > 0.0, spec[a] / jnp.maximum(spec_len, tiny), 0.0)
        for a in range(3)
    )
    t = 1.0 - roughness
    out = tuple(d0[a] * (1.0 - t) + d1[a] * t for a in range(3))
    o_len = jnp.maximum(_norm3(*out), tiny)
    return seed, tuple(out[a] / o_len for a in range(3))


def scatter(seed, normal, ray_dir, roughness, lambertian):
    """AoS wrapper over :func:`scatter_soa` (compatibility surface for
    tests and on-card checks): (R, 3) arrays in, (new_seed, (R, 3)) out."""
    seed, d = scatter_soa(seed, _as_soa(normal), _as_soa(ray_dir),
                          roughness, lambertian)
    return seed, jnp.stack(d, axis=-1)


def raytrace(scene, raycast_fn, origin0, dir0, seed0, sky_color, n_bounces: int,
             lambertian, reorder: bool = False, sort_every: int = 1,
             return_seed: bool = True, seed_recon=None):
    """One path per ray: returns (incoming_light 3x(R,) tuple, new_seed).

    ``return_seed=False`` (single-sample callers) drops the seed from the
    restore sort and returns None for it.

    ``seed_recon(orig, n_draws)`` (optional) recomputes a ray's RNG state
    arithmetically from its original index: an ALIVE ray at bounce i has
    hit exactly i times (alive requires was_hit at every earlier bounce),
    so its state is the initial per-pixel seed advanced a STATIC number
    of draws — the LCG composes in closed form (rng.advance_n).  When
    given (and the final seed is not returned), the reorder sort drops
    the seed column and recomputes it after each sort instead (~10 int
    ops/ray).  Dead rays get garbage states —
    harmless: every later draw they feed is was_hit/alive-masked.  Only
    callers whose pixel/frame assignment is an arithmetic function of the
    original index may pass this (renderer._tile_step's row-major bands).

    ``origin0``/``dir0`` may be (R, 3) arrays or 3-tuples of (R,) columns.

    The reorder/restore sorts are EXACT global multi-operand sorts.

    The reference's per-pixel bounce loop (fragment.glsl:309-350) with the
    emissive-break and miss-break semantics expressed as an alive mask.

    With ``reorder=True``, rays are re-sorted by a Morton/octant coherence
    key (ops/morton.py) before every raycast so packet-style traversals see
    coherent blocks even on bounce rays; each ray carries its own RNG state
    and original index, so results are bit-identical to the unsorted order.

    """
    o3 = _as_soa(origin0)
    d3 = _as_soa(dir0)
    R = o3[0].shape[0]

    # x2 emission in lambertian mode (fragment.glsl:329-331); traced select
    # so the L toggle is a uniform flip, not a recompile.
    emission_scale = jnp.where(jnp.asarray(lambertian, bool),
                               np.float32(2.0), np.float32(1.0))

    if reorder:
        from opengl_raytracer_tpu.ops.morton import ray_sort_keys_soa

        scene_lo = scene.node_min[0]
        scene_hi = scene.node_max[0]

    def body(state, static_i):
        origin, direction, ray_color, incoming, alive, seed, orig = state

        if reorder and static_i > 0 and (static_i - 1) % sort_every == 0:
            # sort_every thins the cadence (perf knob only: sorts are
            # permutations carrying all per-ray state, so any cadence
            # yields the identical image; skipped bounces just traverse
            # one-sort-stale packets).
            # Primary rays (i == 0) arrive screen-coherent; sorting only
            # pays off on bounce rays.  The reorder is a multi-operand
            # lax.sort carrying every per-ray column THROUGH the sort
            # instead of an argsort followed by gathers.
            keys = ray_sort_keys_soa(origin, direction, scene_lo, scene_hi,
                                     alive)
            # 11 operands (12 without seed reconstruction), not 16: every
            # payload column adds sort traffic, so columns are folded away
            # wherever an invariant allows.
            #  * ``incoming`` rides in the origin columns: light is only
            #    ever added at the DEATH event (an emissive hit or a
            #    miss both clear ``alive``, fragment.glsl:327-346), so
            #    live rays always carry incoming == 0, and dead rays
            #    never use their origin again (every later update is
            #    masked by ``alive``).
            #  * ``alive`` is re-derived from the sorted key: dead rays
            #    carry the reserved sentinel 0xFFFFFFFF and live keys
            #    are clamped below it (ops/morton.py).
            merged = tuple(jnp.where(alive, origin[a], incoming[a])
                           for a in range(3))
            recon = seed_recon is not None and not return_seed
            if recon:
                # 11 operands: the seed column is recomputed from orig
                # after the sort (see the docstring) instead of carried.
                (keys_s, m0, m1, m2, d0, d1, d2, c0, c1, c2,
                 orig) = jax.lax.sort(
                    (keys,
                     merged[0], merged[1], merged[2],
                     direction[0], direction[1], direction[2],
                     ray_color[0], ray_color[1], ray_color[2],
                     orig),
                )
                seed = seed_recon(orig, 3 * static_i)
            else:
                (keys_s, m0, m1, m2, d0, d1, d2, c0, c1, c2,
                 seed, orig) = jax.lax.sort(
                    (keys,
                     merged[0], merged[1], merged[2],
                     direction[0], direction[1], direction[2],
                     ray_color[0], ray_color[1], ray_color[2],
                     seed, orig),
                )
            alive = keys_s != np.uint32(0xFFFFFFFF)
            # Dead lanes keep their (finite) incoming values in the
            # origin slots; the raycast masks them out and every origin
            # consumer is alive-gated, so the junk never flows.
            origin = (m0, m1, m2)
            direction = (d0, d1, d2)
            ray_color = (c0, c1, c2)
            zero = jnp.zeros_like(m0)
            incoming = tuple(jnp.where(alive, zero, origin[a])
                             for a in range(3))

        nearest = raycast_fn(origin, direction, alive)
        hit = finalize_hit_soa(scene, origin, direction, nearest)

        seed_h, new_dir = scatter_soa(seed, hit.normal, direction,
                                      hit.roughness, lambertian)

        was_hit = alive & hit.did_hit
        was_miss = alive & ~hit.did_hit

        em = hit.emission * emission_scale
        incoming = tuple(
            incoming[a]
            + jnp.where(was_hit, hit.emission_color[a] * em * ray_color[a],
                        0.0)
            + jnp.where(was_miss, sky_color[a], 0.0)
            for a in range(3)
        )
        ray_color = tuple(
            jnp.where(was_hit, ray_color[a] * hit.color[a], ray_color[a])
            for a in range(3)
        )
        origin = tuple(
            jnp.where(was_hit,
                      hit.point[a] + hit.normal[a] * np.float32(1e-4),
                      origin[a])
            for a in range(3)
        )
        direction = tuple(jnp.where(was_hit, new_dir[a], direction[a])
                          for a in range(3))
        seed = jnp.where(was_hit, seed_h, seed)
        # Terminate on emissive hit (fragment.glsl:338-340) or on miss.
        alive = was_hit & ~(hit.emission > 0.0)
        return origin, direction, ray_color, incoming, alive, seed, orig

    ones = jnp.ones((R,), jnp.float32)
    zeros = jnp.zeros((R,), jnp.float32)
    state = (
        o3,
        d3,
        (ones, ones, ones),
        (zeros, zeros, zeros),
        jnp.ones((R,), bool),
        seed0,
        jnp.arange(R, dtype=jnp.int32),
    )
    # The bounce count is STATIC (a python int from the config), so the
    # loop unrolls: that drops bounce 0's sort branch at trace time and
    # keeps every bounce index static for the profiler.  The reference's early exit on
    # all-paths-dead (fragment.glsl:313's loop bound with breaks) is
    # preserved semantically by the alive masks -- dead rays contribute
    # exactly their frozen incoming light.
    for _i in range(int(n_bounces)):
        state = body(state, static_i=_i)
    incoming, seed, orig = state[3], state[5], state[6]
    if reorder:
        # Restore pixel order: one more multi-operand sort keyed by the
        # original index (cheaper than argsort + gathers, see above).
        # (``incoming`` is already complete here: the origin-column fold
        # is purely a sort-transport trick, unpacked immediately after
        # each sort.)  The seed column rides only when the caller needs
        # it (rays_per_pixel > 1 chains the RNG across samples): XLA does
        # not remove dead sort operands.
        if return_seed:
            _, i0, i1, i2, seed = jax.lax.sort(
                (orig, incoming[0], incoming[1], incoming[2], seed),
            )
        else:
            _, i0, i1, i2 = jax.lax.sort(
                (orig, incoming[0], incoming[1], incoming[2]),
            )
            seed = None
        incoming = (i0, i1, i2)
    return incoming, seed


def trace(scene, raycast_fn, origin0, dir0, seed0, sky_color, n_bounces: int,
          rays_per_pixel: int, lambertian, reorder: bool = False,
          sort_every: int = 1, seed_recon=None):
    """Average ``rays_per_pixel`` independent paths (fragment.glsl:352-366).

    Returns ((R, 3) color, new_seed); inputs may be AoS or SoA."""
    run = partial(
        raytrace,
        scene,
        raycast_fn,
        _as_soa(origin0),
        _as_soa(dir0),
        sky_color=sky_color,
        n_bounces=n_bounces,
        lambertian=lambertian,
        reorder=reorder,
        sort_every=sort_every,
        seed_recon=seed_recon,
    )
    if rays_per_pixel == 1:
        # The per-pixel seed dies here (each frame reseeds from
        # (x, y, frameNumber), fragment.glsl:390) — skip its restore-sort
        # column and return the pre-restore seed for API compatibility.
        color, seed = run(seed0=seed0, return_seed=False)
        return jnp.stack(color, axis=-1), seed if seed is not None else seed0

    def body(seed, _):
        color, seed = run(seed0=seed)
        return seed, jnp.stack(color, axis=-1)

    seed, colors = jax.lax.scan(body, seed0, None, length=rays_per_pixel)
    return colors.mean(axis=0), seed
