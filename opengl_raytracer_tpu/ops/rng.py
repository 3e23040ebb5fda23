"""Counter-free sequential RNG, bit-compatible with the reference shader.

The reference advances a per-pixel uint32 state with an LCG and applies a
PCG-style shift/xor scramble; the output is mapped to **[-1, 1]** (the code
divides by 4294967295, multiplies by 2 and subtracts 1 — the comment in the
shader says [0,1] but the code is signed) (reference: fragment.glsl:206-218).
The per-pixel seed is ``x*1973 ^ y*9277 ^ frameNumber*1664525`` followed by
three warm-up draws (fragment.glsl:390-394).

Everything here is vectorized uint32 math in JAX, so a whole frame of
per-pixel states advances in one elementwise op — the sequence per pixel is
*bit-identical* to the GLSL program, which is what makes converged images
match the reference to float rounding rather than just in distribution.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_U = np.uint32
_LCG_MUL = _U(747796405)
_LCG_ADD = _U(2891336453)
_MIX_MUL = _U(277803737)
# float32(4294967295.0) rounds to 4294967296.0, matching the GLSL literal.
_INV_SCALE = np.float32(4294967295.0)


def seed_pixels(px: jnp.ndarray, py: jnp.ndarray, frame_number) -> jnp.ndarray:
    """Per-pixel seed (fragment.glsl:390). px/py are int arrays; py is in GL
    convention (0 = bottom row)."""
    x = px.astype(jnp.uint32) * _U(1973)
    y = py.astype(jnp.uint32) * _U(9277)
    f = jnp.asarray(frame_number).astype(jnp.uint32) * _U(1664525)
    return x ^ y ^ f


def random_value(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One draw: returns (new_state, value in [-1, 1]) (fragment.glsl:206-218)."""
    state = state * _LCG_MUL + _LCG_ADD
    t = state >> ((state >> _U(28)) + _U(4))
    result = (t ^ state) * _MIX_MUL
    result = (result >> _U(22)) ^ result
    value = result.astype(jnp.float32) / _INV_SCALE * np.float32(2.0) - np.float32(1.0)
    return state, value


def warmup(state: jnp.ndarray, n: int = 3) -> jnp.ndarray:
    """The reference's three warm-up draws after seeding (fragment.glsl:392-394)."""
    for _ in range(n):
        state, _ = random_value(state)
    return state


def advance_constants(n: int) -> tuple[np.uint32, np.uint32]:
    """(A_n, C_n) such that ``advance_n(s, n) == s * A_n + C_n`` equals n
    sequential LCG state advances (the draw's output scramble never feeds
    the state, so the state recurrence is the pure LCG s' = s*M + A and
    composes in closed form mod 2^32).  Host-side statics."""
    a, c = 1, 0
    m, add = int(_LCG_MUL), int(_LCG_ADD)
    for _ in range(int(n)):
        a = (a * m) % (1 << 32)
        c = (c * m + add) % (1 << 32)
    return _U(a), _U(c)


def advance_n(state: jnp.ndarray, n: int) -> jnp.ndarray:
    """State after ``n`` draws (static n), without producing the values —
    bit-identical to n ``random_value`` state updates."""
    a_n, c_n = advance_constants(n)
    return state * a_n + c_n


def random_vec3(state: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Three sequential draws -> (new_state, (..., 3) array), matching the
    component order of ``diffuse`` (fragment.glsl:221)."""
    state, r0 = random_value(state)
    state, r1 = random_value(state)
    state, r2 = random_value(state)
    return state, jnp.stack([r0, r1, r2], axis=-1)
