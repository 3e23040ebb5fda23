"""Multi-chip rendering tests on the 8-device virtual CPU mesh: the sharded
(dp x sp) progressive step must reproduce single-chip sequential rendering
exactly, because sp parallelism partitions *frame numbers* and the per-pixel
RNG stream depends only on (x, y, frameNumber) (fragment.glsl:390)."""

import numpy as np
import jax
import pytest

from opengl_raytracer_tpu.models.rect import Rect
from opengl_raytracer_tpu.models.scene import Scene
from opengl_raytracer_tpu.ops.camera import make_camera
from opengl_raytracer_tpu.parallel.sharding import ShardedRenderer, make_mesh
from opengl_raytracer_tpu.renderer import Renderer
from opengl_raytracer_tpu.utils.config import RenderConfig
from opengl_raytracer_tpu.utils.image import rmse


def small_scene():
    return Scene([
        Rect([4, 4, 0.1], [0, 0, -2], [0, 0, 0], color=[0.8, 0.2, 0.2], roughness=1),
        Rect([4, 4, 0.1], [0, 2, 0], [90, 0, 0], color=[0, 0, 0],
             emission_color=[1, 1, 1], emission=1.0, roughness=1),
        Rect([4, 4, 0.1], [0, -2, 0], [90, 0, 0], color=[0.7, 0.7, 0.7], roughness=1),
    ])


CAM = make_camera([0.0, 0.0, 4.0], [180.0, 0.0])


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 1)])
def test_sharded_matches_sequential(dp, sp):
    if dp * sp > len(jax.devices()):
        pytest.skip("not enough devices")
    cfg = RenderConfig(width=16, height=16, bounces=2, traversal="bvh")
    scene = small_scene()

    mesh = make_mesh(dp * sp, dp=dp, sp=sp)
    sr = ShardedRenderer(scene, cfg, mesh)
    state = sr.render(camera=CAM, frames=2 * sp)
    sharded_img = sr.image(state)

    r = Renderer(scene, cfg)
    seq = r.render(camera=CAM, frames=2 * sp)
    seq_img = r.image(seq)

    assert state.frame_count == 2 * sp
    assert rmse(sharded_img, seq_img) < 1e-6


def test_sharded_packet_matches_sequential():
    """The production packet traversal must compose with shard_map: each
    device traverses its ray shard against the replicated scene (on the
    card: ``chip_smoke.py --multi``)."""
    cfg = RenderConfig(width=16, height=16, bounces=2, traversal="packet")
    scene = small_scene()

    mesh = make_mesh(2, dp=2, sp=1)
    sr = ShardedRenderer(scene, cfg, mesh)
    assert sr.traversal == "packet"
    state = sr.render(camera=CAM, frames=1)
    sharded_img = sr.image(state)

    r = Renderer(scene, cfg)
    seq_img = r.image(r.render(camera=CAM, frames=1))
    assert rmse(sharded_img, seq_img) < 1e-6


@pytest.mark.parametrize("w,h,tile_size", [(16, 16, 2), (16, 20, 3)])
def test_sharded_tiles_match_sequential(w, h, tile_size):
    """Tile scheduling under dp sharding: band rows are sharded across
    devices.  The (16, 20, 3) case has tile_h=6 with a remainder (20 =
    3*6 + 2), so the sharded clamp+mask merge of remainder bands —
    reachable whenever dp | tile_h but tile_h does not divide H — is
    actually exercised."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    cfg = RenderConfig(width=w, height=h, bounces=2, tile_size=tile_size,
                       traversal="bvh")
    assert cfg.tile_h % 2 == 0, "param must keep the band dp-divisible"
    scene = small_scene()

    mesh = make_mesh(4, dp=2, sp=2)
    sr = ShardedRenderer(scene, cfg, mesh)
    state = sr.render(camera=CAM, frames=2)
    sharded_img = sr.image(state)

    r = Renderer(scene, RenderConfig(width=w, height=h, bounces=2,
                                     traversal="bvh"))
    seq = r.render(camera=CAM, frames=2)
    seq_img = r.image(seq)

    assert rmse(sharded_img, seq_img) < 1e-6


def test_sharded_packet_odd_shard_parity():
    """A per-device ray shard that is NOT a multiple of 128 (here 8 rows x
    12 cols = 96 rays/device) must still run the packet traversal —
    render_flat pads the shard to whole packets — instead of silently
    downgrading to the per-ray walk."""
    cfg = RenderConfig(width=12, height=16, bounces=1, traversal="packet")
    scene = small_scene()

    mesh = make_mesh(2, dp=2, sp=1)
    sr = ShardedRenderer(scene, cfg, mesh)
    assert sr.traversal == "packet"  # no downgrade
    sharded_img = sr.image(sr.render(camera=CAM, frames=1))

    r = Renderer(scene, cfg)
    seq_img = r.image(r.render(camera=CAM, frames=1))
    assert rmse(sharded_img, seq_img) < 1e-6


def test_sharded_checkpoint_resume(tmp_path):
    """Checkpoint/restore round-trip across the mesh: a sharded render interrupted at the half-way point and resumed from disk
    is bit-identical to an uninterrupted one."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")
    from opengl_raytracer_tpu.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    cfg = RenderConfig(width=16, height=16, bounces=2, tile_size=2,
                       traversal="bvh")
    scene = small_scene()
    mesh = make_mesh(4, dp=2, sp=2)
    sr = ShardedRenderer(scene, cfg, mesh)

    full = sr.render(camera=CAM, frames=4)

    half = sr.render(camera=CAM, frames=2)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, half, cam_pos=[0.0, 0.0, 4.0], cam_dir=[180.0, 0.0])

    loaded, cam_pos, cam_dir = load_checkpoint(path)
    resumed = sr.restore_state(loaded)
    assert resumed.frame_count == 2
    cam = make_camera(cam_pos, cam_dir)
    resumed = sr.render(camera=cam, frames=2, state=resumed)

    a, b = sr.image(full), sr.image(resumed)
    np.testing.assert_array_equal(a, b)


def test_mesh_factory_validation():
    with pytest.raises(ValueError):
        make_mesh(4, dp=3, sp=2)
