"""Camera model: yaw/pitch basis on host, angle-linear projection on device.

The reference computes an orthonormal (right, forward, up) basis from yaw and
pitch in degrees (reference: main.py:211-237) and generates rays with an
**angle-linear** projection — NOT a tan-based pinhole: the ray direction is
``camRight * (dirStartX + u * xStep) + camUp * (dirStartY + v * yStep) +
camForward``, normalized, with ``dirStartX = -fov/2 * aspect``, ``xStep =
fov * aspect``, ``dirStartY = -fov/2``, ``yStep = fov`` and ``fov =
radians(90)`` (main.py:166-170, fragment.glsl:368-374).  This exact math is
required for pixel equivalence with the reference.

UV conventions follow GL: uv = ((px + 0.5) / W, (py + 0.5) / H) with py = 0
the *bottom* row (the fullscreen quad interpolates uv over [0,1]^2,
screen.py:10-18).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class Camera(NamedTuple):
    """Camera pytree (all (3,) float32 device arrays + scalar floats)."""

    pos: jnp.ndarray
    right: jnp.ndarray
    up: jnp.ndarray
    forward: jnp.ndarray


def camera_basis(cam_dir) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(right, forward, up) from (yaw_deg, pitch_deg) (main.py:211-237)."""
    yaw = math.radians(float(cam_dir[0]))
    pitch = math.radians(float(cam_dir[1]))

    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)

    forward = np.array([sy * cp, sp, cy * cp], dtype=np.float32)
    forward /= np.linalg.norm(forward)

    world_up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    right = np.cross(world_up, forward)
    right /= np.linalg.norm(right)
    up = np.cross(forward, right)
    up /= np.linalg.norm(up)
    return right, forward, up


def make_camera(pos, cam_dir) -> Camera:
    """Build a Camera pytree from position and (yaw, pitch) degrees."""
    right, forward, up = camera_basis(cam_dir)
    return Camera(
        pos=jnp.asarray(pos, dtype=jnp.float32),
        right=jnp.asarray(right),
        up=jnp.asarray(up),
        forward=jnp.asarray(forward),
    )


def ray_dirs(camera: Camera, u: jnp.ndarray, v: jnp.ndarray, width: int, height: int,
             fov: float = math.radians(90.0),
             aspect: float | None = None) -> jnp.ndarray:
    """Angle-linear primary ray directions for uv arrays of shape (R,).

    Exact ``getDir`` math (fragment.glsl:368-374) with the uniform setup of
    main.py:166-170.  The reference computes ``aspect`` from the DISPLAY
    size (``sw / sh``, main.py:137), not the render size — pass it when the
    two differ (App threads ``screen_size``'s aspect through the config);
    default is the render aspect, equal under the reference's defaults
    (main.py:470 sizes the window from the same monitor aspect).
    """
    d = ray_dirs_soa(camera, u, v, width, height, fov=fov, aspect=aspect)
    return jnp.stack(d, axis=-1)


def ray_dirs_soa(camera: Camera, u: jnp.ndarray, v: jnp.ndarray,
                 width: int, height: int,
                 fov: float = math.radians(90.0),
                 aspect: float | None = None) -> tuple:
    """SoA form of :func:`ray_dirs`: returns a 3-tuple of (R,) direction
    columns (see ops/integrator.py for why the renderer keeps columns)."""
    if aspect is None:
        aspect = width / height
    dir_start_x = -fov / 2.0 * aspect
    dir_start_y = -fov / 2.0
    x_step = fov * aspect
    y_step = fov

    dx = dir_start_x + u * x_step
    dy = dir_start_y + v * y_step
    d = tuple(
        camera.right[a] * dx + camera.up[a] * dy + camera.forward[a]
        for a in range(3)
    )
    d_len = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return tuple(d[a] / d_len for a in range(3))


def pixel_uv(px: jnp.ndarray, py: jnp.ndarray, width: int, height: int):
    """GL-convention uv at pixel centers; py = 0 is the bottom row."""
    u = (px.astype(jnp.float32) + 0.5) / width
    v = (py.astype(jnp.float32) + 0.5) / height
    return u, v
