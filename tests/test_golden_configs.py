"""Golden tests for BASELINE.json configs 2-4 at reduced resolution.

Each config renders with the vectorized renderer and must match the scalar
GLSL-semantics oracle (tests/oracle.py) within RMSE 1e-4.  Coverage:
multi-object scenes, specular
(roughness 0 and 0.5) paths, 3+ bounce depths, rays_per_pixel > 1, and
multi-frame progressive accumulation — each through the production packet
traversal, checked against the oracle directly.

Reference math: fragment.glsl:309-416; accumulation fragment.glsl:409-414.
"""

import os

import numpy as np
import pytest

from opengl_raytracer_tpu.models.mesh import Mesh
from opengl_raytracer_tpu.models.rect import Rect
from opengl_raytracer_tpu.models.scene import Scene
from opengl_raytracer_tpu.ops.camera import camera_basis, make_camera
from opengl_raytracer_tpu.renderer import Renderer
from opengl_raytracer_tpu.utils.config import RenderConfig
from opengl_raytracer_tpu.utils.image import rmse

import oracle

pytestmark = pytest.mark.skipif(
    not os.path.isdir("/root/reference/models"), reason="reference assets absent"
)

CAM = ((0.0, 0.0, 0.0), (0.0, 0.0))


def assert_golden(img, ref, outlier_frac=0.002):
    """RMSE < 1e-4 excluding isolated grazing-edge pixels.

    The oracle runs float64; at surface-edge grazing incidences a
    last-ulp difference in the float32 scatter direction flips a later
    bounce between hit and miss, producing a handful of wildly different
    pixels (verified: first hits agree to 4e-7 relative; the divergence
    appears only in bounce >= 2 near silhouette edges).  Those pixels are
    a precision artifact of the comparison, not an implementation
    difference, so up to ``outlier_frac`` of pixels may differ freely
    while everything else must match tightly.

    Adversarial guard on the allowance: a
    real implementation bug (wrong material, shifted tile, bad traversal
    region) produces CLUSTERED wrong pixels, while grazing-edge RNG
    divergence produces isolated ones — so no outlier may have 3+ outlier
    neighbors in its 3x3 neighborhood (a silhouette edge passing through
    a pixel's neighborhood yields at most 2 collinear neighbors).
    """
    diff = np.abs(img - ref).max(axis=-1)
    n_out = int(diff.size * outlier_frac) + 1
    keep = diff <= np.partition(diff.ravel(), -n_out)[-n_out]
    masked_rmse = float(np.sqrt(np.mean((img[keep] - ref[keep]) ** 2)))
    assert masked_rmse < 1e-4, masked_rmse
    out = diff > 1e-3
    assert out.mean() <= outlier_frac, out.mean()
    padded = np.pad(out, 1)
    neigh = sum(
        padded[1 + dy:padded.shape[0] - 1 + dy,
               1 + dx:padded.shape[1] - 1 + dx]
        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
        if (dy, dx) != (0, 0)
    )
    clustered = out & (neigh >= 3)
    assert clustered.sum() == 0, (
        f"{clustered.sum()} outlier pixels form clusters at "
        f"{np.argwhere(clustered)[:8].tolist()}"
    )


def run_both(objects, w, h, bounces, frames=1, spp=1, lambertian=True,
             traversal="packet", leaf=16):
    scene = Scene(objects, max_leaf_tris=leaf)
    cfg = RenderConfig(width=w, height=h, bounces=bounces,
                       rays_per_pixel=spp, lambertian=lambertian,
                       traversal=traversal)
    r = Renderer(scene, cfg)
    cam_pos, cam_dir = CAM
    state = r.render(camera=make_camera(cam_pos, cam_dir), frames=frames)
    img = r.image(state)

    right, forward, up = camera_basis(cam_dir)
    osc = oracle.OracleScene.from_scene(scene)
    refs = [
        oracle.render(
            osc, w, h, np.array(cam_pos), right, up, forward, bounces,
            rays_per_pixel=spp, jitter=cfg.jitter_amount,
            lambertian=lambertian, sky_brightness=1.0, frame_number=f,
        )
        for f in range(frames)
    ]
    return img, np.mean(refs, axis=0)


def test_config2_ground_scene_specular():
    """Config-2 analog (car asset is stripped from the mount): textured
    ground plane + mirror rect + half-rough box, 2 bounces."""
    objs = [
        Mesh([0, -3, 10], [0, 0, 0], "ground", color=[0.7, 0.7, 0.6],
             roughness=1.0, scale=4),
        Rect([3, 3, 0.2], [0, 0, 14], [0, 15, 0], color=[0.9, 0.9, 0.9],
             roughness=0.0),                      # mirror
        Rect([1.5, 1.5, 1.5], [-2, -1, 9], [0, 30, 0], color=[0.8, 0.3, 0.2],
             roughness=0.5),                      # glossy
    ]
    img, ref = run_both(objs, 64, 48, bounces=2)
    assert_golden(img, ref)


def test_config3_knight_sphere_multiobject():
    """Config-3 analog: knight + sphere + emissive panel, 3 bounces."""
    objs = [
        Mesh([0, -1, 8], [0, 180, 0], "knight", color=[0.8, 0.75, 0.6],
             roughness=1.0, scale=1.5),
        Mesh([3, 0, 12], [0, 0, 0], "sphere", color=[0.3, 0.4, 0.9],
             roughness=0.0, scale=2),             # mirror sphere
        Rect([6, 0.2, 6], [0, 4, 10], [0, 0, 0], color=[0, 0, 0],
             emission_color=[1, 1, 1], emission=1.2, roughness=1.0),
    ]
    img, ref = run_both(objs, 48, 48, bounces=3)
    assert_golden(img, ref)


def test_config4_dragon_accumulation_spp():
    """Config-4 analog: minidragon, 4 bounces, spp=2, 2 progressive
    frames — exercises the sample loop's sequential RNG carry
    (fragment.glsl:352-366) and the running-mean accumulation."""
    objs = [
        Mesh([0, -1, 9], [270, 0, -90], "stanford_minidragon",
             color=[0.9, 0.85, 0.7], roughness=1.0, scale=0.4),
        Rect([8, 0.2, 8], [0, -2, 10], [0, 0, 0], color=[0.6, 0.6, 0.65],
             roughness=1.0),
    ]
    img, ref = run_both(objs, 48, 32, bounces=4, frames=2, spp=2)
    assert_golden(img, ref)


def test_config3_packet_oracle():
    """The production packet traversal against the oracle on the knight
    alone with its light (no mirror sphere)."""
    objs = [
        Mesh([0, -1, 8], [0, 180, 0], "knight", color=[0.8, 0.75, 0.6],
             roughness=1.0, scale=1.5),
        Rect([6, 0.2, 6], [0, 4, 10], [0, 0, 0], color=[0, 0, 0],
             emission_color=[1, 1, 1], emission=1.2, roughness=1.0),
    ]
    img, ref = run_both(objs, 32, 32, bounces=2, traversal="packet")
    assert_golden(img, ref)


def test_display_aspect_golden():
    """window_size != screen_size: ray generation must use the DISPLAY
    aspect (reference main.py:137 computes aspect = sw/sh and feeds it to
    the dirStartX/xStep uniforms, main.py:166-170) — a real divergence
    from the render aspect whenever the two differ.  The oracle is fed the display aspect directly."""
    from opengl_raytracer_tpu.app import App

    objs = [
        Rect([3, 3, 0.2], [0, 0, 10], [0, 0, 0], color=[0.8, 0.3, 0.2],
             roughness=1.0),
        Rect([8, 0.2, 8], [0, -2, 8], [0, 0, 0], color=[0.6, 0.6, 0.65],
             roughness=1.0),
    ]
    w, h = 48, 32
    sw, sh = 96, 40  # display aspect 2.4 vs render aspect 1.5
    app = App(window_size=(w, h), screen_size=(sw, sh), bounces=1,
              scene=Scene(objs, max_leaf_tris=16), headless=True,
              run=False)
    assert app.config.aspect == sw / sh
    cam = make_camera(*CAM)
    app.state = app.renderer.step(app.state, cam)
    img = app.image()

    cam_pos, cam_dir = CAM
    right, forward, up = camera_basis(cam_dir)
    osc = oracle.OracleScene.from_scene(Scene(objs, max_leaf_tris=16))
    ref = oracle.render(osc, w, h, np.array(cam_pos), right, up, forward,
                        bounces=1, aspect=sw / sh)
    assert_golden(img, ref)

    # And the default (screen_size=None) stays on the render aspect.
    ref_default = oracle.render(osc, w, h, np.array(cam_pos), right, up,
                                forward, bounces=1)
    assert rmse(ref, ref_default) > 1e-3  # the aspects genuinely diverge


def test_config2_non_lambertian_golden():
    """Hemisphere-scatter mode (L toggle off) against the oracle."""
    objs = [
        Mesh([0, -3, 10], [0, 0, 0], "ground", color=[0.7, 0.7, 0.6],
             roughness=1.0, scale=4),
        Rect([1.5, 1.5, 1.5], [-2, -1, 9], [0, 30, 0], color=[0.8, 0.3, 0.2],
             roughness=0.5),
    ]
    img, ref = run_both(objs, 40, 32, bounces=2, lambertian=False)
    assert_golden(img, ref)
