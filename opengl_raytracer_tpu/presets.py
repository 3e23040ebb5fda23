"""Preset scenes and benchmark configurations.

``default_scene`` rebuilds the reference's hard-coded Cornell-box variant
(reference: main.py:19-111) object-for-object: dragon mesh, mirror sphere,
red/blue/green walls, mirror front wall, floor, back wall, and the white
area light.  Both meshes are generated in code by default
(models/procedural.py): a seeded 23,490-triangle blob stands in for the
dragon and the sphere is the reference's 64x32 UV sphere, so the scene
needs no asset file.  Pass ``dragon="stanford_mediumdragon"`` or any OBJ
name or path to load a dragon through ``resolve_obj_path`` instead; a
missing asset raises.

``baseline_configs`` mirrors BASELINE.json's five benchmark configs.
"""

from __future__ import annotations

from opengl_raytracer_tpu.models import procedural
from opengl_raytracer_tpu.models.mesh import Mesh
from opengl_raytracer_tpu.models.rect import Rect
from opengl_raytracer_tpu.models.scene import Scene
from opengl_raytracer_tpu.utils.config import RenderConfig

DEFAULT_CAM_POS = (-33.7, 14.8, -21.1)  # main.py:151
DEFAULT_CAM_DIR = (65.0, -25.4)  # main.py:152


# Top of the floor slab (the third Rect below: 1 unit thick at y = -25).
_FLOOR_Y = -24.5
# Per-axis size of the dragon's stand-in: about a third of the 60-unit box
# wide, on the floor under the dragon's own position (main.py:20-27).
_BLOB_SCALE = (9.0, 13.0, 10.0)


def default_objects(dragon: str | None = None) -> list:
    """The reference's default scene objects (main.py:19-99).  ``dragon``
    None uses the generated stand-in; a name or path loads that OBJ."""
    if dragon is None:
        dragon_obj = procedural.blob(
            [-5, _FLOOR_Y + _BLOB_SCALE[1], 0], [0, 0, 0], [0.96, 0.96, 0.86],
            roughness=1, scale=_BLOB_SCALE)
    else:
        dragon_obj = Mesh([-5, -10, 0], [270, 0, -90], dragon,
                          [0.96, 0.96, 0.86], roughness=1, scale=0.25)
    return [
        dragon_obj,
        procedural.uv_sphere([-25, -20, 20], [0, 0, 0], color=[1, 1, 1],
                             roughness=0, scale=7),
        Rect([8, 5, 0.1], [0, 0, 30], [0, 0, 0], [1, 0.25, 0.3],
             roughness=1, scale=10),
        Rect([8, 5, 0.1], [0, 0, -30], [0, 0, 0], [0.3, 0.25, 1],
             roughness=1, scale=10),
        Rect([8, 6, 0.1], [0, -25, 0], [90, 0, 0], [0.25, 1, 0.3],
             roughness=1, scale=10),
        Rect([6, 8, 0.1], [25, 0, 0], [0, 90, 0], [0.9, 0.9, 0.9],
             roughness=0, scale=10),
        Rect([8, 6, 0.1], [0, 25, 0], [90, 0, 0], [1, 1, 1],
             roughness=1, scale=10),
        Rect([5, 5, 0.25], [0, 23.9, 0], [-90, 0, 0], [0, 0, 0],
             [1, 1, 1], 1.5, scale=5),
        Rect([6, 8, 0.1], [-35, 0, 0], [0, 90, 0], [0.9, 0.9, 0.9],
             roughness=1, scale=10),
    ]


def default_scene(dragon: str | None = None, max_leaf_tris: int = 32,
                  **scene_kw) -> Scene:
    """The reference's default scene, in its Scene order (main.py:101-111)."""
    return Scene(default_objects(dragon), max_leaf_tris=max_leaf_tris, **scene_kw)


def default_config(**overrides) -> RenderConfig:
    """The reference's __main__ defaults (main.py:447-454) at 1080p."""
    base = dict(
        width=1920, height=1080, bounces=7, rays_per_pixel=1,
        jitter_amount=0.001, lambertian=True, sky_brightness=1.0, tile_size=1,
    )
    base.update(overrides)
    return RenderConfig(**base)


def baseline_configs() -> dict[str, dict]:
    """BASELINE.json's five benchmark configurations (scene factory +
    RenderConfig)."""
    from opengl_raytracer_tpu.models.trisoup import Triangles  # noqa: F401

    return {
        # Asset frames (measured): sphere r~1 (origin), knight ~4.7 tall
        # along +z, dragon ~150 wide z-up, ground 20x20 plane at y=0.
        "sphere_256": dict(
            objects=lambda: [Mesh([0, 0, 12], [0, 0, 0], "sphere",
                                  color=[0.9, 0.4, 0.3], roughness=1, scale=7)],
            config=RenderConfig(width=256, height=256, bounces=1),
            cam_pos=(0.0, 0.0, 0.0), cam_dir=(0.0, 0.0),
        ),
        "ground_car_512": dict(
            objects=lambda: [
                Mesh([0, -2, 10], [0, 0, 0], "ground", color=[0.6, 0.6, 0.55],
                     roughness=1, scale=2),
                # models/car/car.obj is stripped from the mount; supply via
                # OGLRT_MODELS_PATH at eval time, else knight stands in.
                Mesh([0, -2, 14], [0, 180, 0], "car", color=[0.7, 0.1, 0.1],
                     roughness=0.5, scale=2),
            ],
            fallback_objects=lambda: [
                Mesh([0, -2, 10], [0, 0, 0], "ground", color=[0.6, 0.6, 0.55],
                     roughness=1, scale=2),
                Mesh([0, -2, 14], [-90, 0, 0], "knight", color=[0.7, 0.1, 0.1],
                     roughness=0.5, scale=2),
            ],
            config=RenderConfig(width=512, height=512, bounces=2),
            cam_pos=(0.0, 3.0, 0.0), cam_dir=(0.0, -12.0),
        ),
        "knight_airplane_1024": dict(
            objects=lambda: [
                Mesh([-6, -3, 18], [-90, 0, 0], "knight", color=[0.8, 0.8, 0.85],
                     roughness=1, scale=2),
                # airplane OBJs stripped; dragon stands in as second object
                Mesh([8, -2, 24], [-90, 0, 0], "dragon", color=[0.5, 0.6, 0.9],
                     roughness=0.8, scale=0.08),
            ],
            config=RenderConfig(width=1024, height=1024, bounces=3),
            cam_pos=(0.0, 2.0, 0.0), cam_dir=(0.0, -5.0),
        ),
        # Config 4 runs on the generated default scene (27,542 triangles,
        # the minidragon scene's count).
        "minidragon_1080p": dict(
            objects=lambda: default_objects(),
            config=default_config(bounces=4),
            cam_pos=DEFAULT_CAM_POS, cam_dir=DEFAULT_CAM_DIR,
        ),
        "mediumdragon_1080p": dict(
            objects=lambda: default_objects("stanford_mediumdragon"),
            fallback_objects=lambda: default_objects(),
            config=default_config(bounces=4, rays_per_pixel=4),
            cam_pos=DEFAULT_CAM_POS, cam_dir=DEFAULT_CAM_DIR,
        ),
    }
