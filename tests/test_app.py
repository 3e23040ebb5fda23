"""App driver, CLI, and checkpoint/resume tests (headless, CPU)."""

import numpy as np

from opengl_raytracer_tpu.app import App
from opengl_raytracer_tpu.models.rect import Rect
from opengl_raytracer_tpu.models.scene import Scene
from opengl_raytracer_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from opengl_raytracer_tpu.utils.image import load_png, rmse


def tiny_scene():
    return Scene([
        Rect([4, 4, 0.1], [0, 0, -2], [0, 0, 0], color=[0.8, 0.2, 0.2], roughness=1),
        Rect([2, 2, 0.1], [0, 1.9, 0], [90, 0, 0], color=[0, 0, 0],
             emission_color=[1, 1, 1], emission=1.0, roughness=1),
    ])


def test_headless_app_renders_and_saves(tmp_path):
    out = str(tmp_path / "out.png")
    app = App(
        window_size=(16, 16), bounces=1, scene=tiny_scene(),
        headless=True, max_frames=2, output=out,
    )
    assert app.state.frame_count == 2
    img = load_png(out)
    assert img.shape == (16, 16, 3)


def test_headless_remainder_tiles_full_sweeps(tmp_path):
    """The headless loop must run num_tiles_x * num_tiles_y steps per frame
    (NOT tile_size**2): at tileSize=3 on 16px, tile_w = 5 so a sweep is 4x4
    bands.  Frame counts and the image must match
    the untiled render exactly."""
    tiled = App(window_size=(16, 16), bounces=1, tileSize=3,
                scene=tiny_scene(), headless=True, max_frames=2,
                output=str(tmp_path / "t.png"))
    assert tiled.renderer.config.num_tiles_x == 4  # ceil(16 / (16//3))
    assert tiled.state.frame_count == 2
    assert tiled.state.tile_x == 0 and tiled.state.tile_y == 0

    flat = App(window_size=(16, 16), bounces=1, tileSize=1,
               scene=tiny_scene(), headless=True, max_frames=2,
               output=str(tmp_path / "f.png"))
    np.testing.assert_array_equal(tiled.image(), flat.image())


def test_checkpoint_resume_bit_exact(tmp_path):
    path = str(tmp_path / "ck.npz")
    # 4 frames straight
    a = App(window_size=(16, 16), bounces=1, scene=tiny_scene(),
            headless=True, max_frames=4, output=str(tmp_path / "a.png"))
    # 2 frames, checkpoint, resume 2 more
    b = App(window_size=(16, 16), bounces=1, scene=tiny_scene(),
            headless=True, max_frames=2, output=str(tmp_path / "b1.png"))
    save_checkpoint(path, b.state, b.camPos, b.camDir)
    state, cp, cd = load_checkpoint(path)
    assert state.frame_count == 2
    c = App(window_size=(16, 16), bounces=1, scene=tiny_scene(),
            headless=True, max_frames=2, output=str(tmp_path / "b2.png"),
            run=False)
    c.state = state
    c.camPos, c.camDir = cp.astype(np.float32), cd.astype(np.float32)
    c.camera = c._make_camera()
    c.main()
    assert c.state.frame_count == 4
    assert rmse(a.image(), c.image()) < 1e-7


def test_reset_frames():
    app = App(window_size=(16, 16), bounces=1, scene=tiny_scene(),
              headless=True, max_frames=1, output="/dev/null", run=False)
    app.state = app.renderer.step(app.state, app.camera)
    assert app.state.frame_count == 1
    app.resetFrames()
    assert app.state.frame_count == 0
    assert float(np.abs(app.renderer.image(app.state)).max()) == 0.0


def test_cli_parser_defaults():
    from opengl_raytracer_tpu.__main__ import build_parser

    args = build_parser().parse_args([])
    assert args.width == 960 and args.bounces == 7 and not args.interactive
    assert args.dragon is None  # the generated default scene
    args = build_parser().parse_args(["--obj", "x.obj", "--traversal", "packet"])
    assert args.obj == "x.obj" and args.traversal == "packet"


def test_mediumdragon_eval_time_injection(tmp_path, monkeypatch):
    """A user supplies the reference's ``stanford_mediumdragon`` OBJ under
    OGLRT_MODELS_PATH: stage an OBJ written from a coarse generated mesh in
    a tmp root under that name and render the FULL default scene through
    ``App(dragon="stanford_mediumdragon")``; the sphere stays generated."""
    from assets import write_obj

    from opengl_raytracer_tpu.models import procedural
    from opengl_raytracer_tpu.models.mesh import resolve_obj_path

    staged = tmp_path / "stanford_mediumdragon"
    staged.mkdir()
    write_obj(staged / "Dragon_medium.obj",
              procedural.blob([0, 0, 0], [0, 0, 0], scale=40, segments=12,
                              rings=8))
    monkeypatch.setenv("OGLRT_MODELS_PATH", str(tmp_path))

    assert resolve_obj_path("stanford_mediumdragon") == str(
        staged / "Dragon_medium.obj")

    out = str(tmp_path / "out.png")
    app = App(window_size=(32, 24), bounces=2,
              dragon="stanford_mediumdragon", headless=True, max_frames=1,
              output=out)
    # staged dragon (2 * 12 * 7 tris) + sphere (3,968) + 7 rects (84)
    assert app.scene.total_triangles == 168 + 3968 + 84
    img = load_png(out)
    assert img.shape == (24, 32, 3) and np.isfinite(img).all()
