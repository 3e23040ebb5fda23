"""End-to-end render tests: the vectorized JAX renderer vs the scalar GLSL
oracle, BVH-vs-brute image equality, progressive accumulation, and tile
scheduling invariance."""

import numpy as np
import pytest

from opengl_raytracer_tpu.models.rect import Rect
from opengl_raytracer_tpu.models.scene import Scene
from opengl_raytracer_tpu.models.trisoup import Triangles
from opengl_raytracer_tpu.ops.camera import camera_basis, make_camera
from opengl_raytracer_tpu.renderer import Renderer, RenderState
from opengl_raytracer_tpu.utils.config import RenderConfig
from opengl_raytracer_tpu.utils.image import rmse

import oracle


def cornellish_objects():
    """A small closed-box scene with an emissive ceiling panel."""
    return [
        Rect([4, 4, 0.1], [0, 0, -2], [0, 0, 0], color=[0.8, 0.2, 0.2], roughness=1),
        Rect([4, 4, 0.1], [0, -2, 0], [90, 0, 0], color=[0.2, 0.8, 0.2], roughness=1),
        Rect([4, 4, 0.1], [0, 2, 0], [90, 0, 0], color=[0.9, 0.9, 0.9], roughness=1),
        Rect([1.5, 1.5, 0.1], [0, 1.9, 0], [90, 0, 0], color=[0, 0, 0],
             emission_color=[1, 1, 1], emission=1.5, roughness=1),
        Triangles(
            [[[-1, -1, 0.5], [1, -1, 0.5], [0, 1, 0.5]]],
            color=(0.3, 0.3, 0.9), roughness=0.0,
        ),
    ]


def make_camera_for_test():
    pos = np.array([0.0, 0.0, 4.0], dtype=np.float32)
    cam_dir = (180.0, 0.0)  # look down -z... yaw 180 -> forward (0,0,-1)
    return pos, cam_dir


def run_jax(objects, w=24, h=20, bounces=2, frames=1, traversal="brute", **kw):
    cfg = RenderConfig(width=w, height=h, bounces=bounces, traversal=traversal,
                       **kw)
    scene = Scene(objects, max_leaf_tris=cfg.max_leaf_tris)
    r = Renderer(scene, cfg)
    pos, cam_dir = make_camera_for_test()
    state = r.render(camera=make_camera(pos, cam_dir), frames=frames)
    return r.image(state), scene, cfg


def run_oracle(scene, cfg, frames=1):
    pos, cam_dir = make_camera_for_test()
    right, forward, up = camera_basis(cam_dir)
    osc = oracle.OracleScene.from_scene(scene)
    imgs = [
        oracle.render(
            osc, cfg.width, cfg.height, pos.astype(np.float64), right, up,
            forward, cfg.bounces, rays_per_pixel=cfg.rays_per_pixel,
            jitter=cfg.jitter_amount, lambertian=cfg.lambertian,
            sky_brightness=cfg.sky_brightness, frame_number=f,
        )
        for f in range(frames)
    ]
    return np.mean(imgs, axis=0)


def test_matches_oracle_single_bounce():
    img, scene, cfg = run_jax(cornellish_objects(), bounces=0)
    ref = run_oracle(scene, cfg)
    assert rmse(img, ref) < 1e-5


def test_matches_oracle_multi_bounce():
    img, scene, cfg = run_jax(cornellish_objects(), bounces=3)
    ref = run_oracle(scene, cfg)
    assert rmse(img, ref) < 1e-4


def test_matches_oracle_non_lambertian():
    img, scene, cfg = run_jax(cornellish_objects(), bounces=2, lambertian=False)
    ref = run_oracle(scene, cfg)
    assert rmse(img, ref) < 1e-4


def test_matches_oracle_multi_spp():
    img, scene, cfg = run_jax(cornellish_objects(), bounces=1, rays_per_pixel=3)
    ref = run_oracle(scene, cfg)
    assert rmse(img, ref) < 1e-4


def test_progressive_accumulation_is_mean():
    img2, scene, cfg = run_jax(cornellish_objects(), bounces=1, frames=2)
    ref = run_oracle(scene, cfg, frames=2)
    assert rmse(img2, ref) < 1e-4


@pytest.mark.slow
def test_bvh_matches_brute_image():
    img_b, _, _ = run_jax(cornellish_objects(), bounces=2, traversal="brute")
    img_v, _, _ = run_jax(cornellish_objects(), bounces=2, traversal="bvh")
    assert rmse(img_b, img_v) < 1e-5


@pytest.mark.slow
def test_packet_matches_brute_image():
    img_b, _, _ = run_jax(cornellish_objects(), bounces=2, traversal="brute")
    img_p, _, _ = run_jax(cornellish_objects(), bounces=2, traversal="packet")
    assert rmse(img_b, img_p) < 1e-5


def test_packet_block_ordering_matches():
    # Resolution divisible by the 8x16 packet block -> block reorder path
    img_b, _, _ = run_jax(cornellish_objects(), w=32, h=16, bounces=2,
                          traversal="brute")
    img_p, _, _ = run_jax(cornellish_objects(), w=32, h=16, bounces=2,
                          traversal="packet")
    assert rmse(img_b, img_p) < 1e-5


def test_tiles_match_full_frame():
    img_full, _, _ = run_jax(cornellish_objects(), w=24, h=20, bounces=1,
                             tile_size=1)
    img_tiled, _, _ = run_jax(cornellish_objects(), w=24, h=20, bounces=1,
                              tile_size=4)
    assert rmse(img_full, img_tiled) < 1e-6


def test_ray_chunking_invariance():
    img_one, _, _ = run_jax(cornellish_objects(), bounces=1)
    img_chunked, _, _ = run_jax(cornellish_objects(), bounces=1, ray_chunk=64)
    assert rmse(img_one, img_chunked) < 1e-6


def test_sky_only_scene():
    # Ray straight up sees only sky: value = sky color * brightness
    objs = [Triangles([[[100, -1, 100], [101, -1, 100], [100, -1, 101]]],
                      color=(1, 1, 1))]
    img, _, cfg = run_jax(objs, w=8, h=8, bounces=0, jitter_amount=0.0)
    assert np.allclose(img[4, 4], np.array(oracle.SKY), atol=1e-5)


def test_emissive_terminates_path():
    # Camera staring at a pure emitter: pixel = 2 * emission (lambertian x2)
    objs = [Rect([4, 4, 0.1], [0, 0, -2], [0, 0, 0], color=[0, 0, 0],
                 emission_color=[1.0, 0.5, 0.25], emission=1.5, roughness=1)]
    img, _, cfg = run_jax(objs, w=8, h=8, bounces=3, jitter_amount=0.0)
    np.testing.assert_allclose(
        img[4, 4], np.array([1.0, 0.5, 0.25]) * 1.5 * 2.0, rtol=1e-5
    )


def test_remainder_tiles_match_full_frame():
    """tile_size need not divide the frame (reference modulo gating,
    fragment.glsl:382-386): 25x19 with 7 tiles/axis -> tile 3x2, so the
    last column band covers 1 px and the last row band 1 px."""
    img_full, _, _ = run_jax(cornellish_objects(), w=25, h=19, bounces=1,
                             tile_size=1)
    img_tiled, _, _ = run_jax(cornellish_objects(), w=25, h=19, bounces=1,
                              tile_size=7)
    assert rmse(img_full, img_tiled) < 1e-6


def test_remainder_tiles_multi_frame_accum():
    """Remainder tiles must keep per-pixel sample streams intact across
    progressive frames (each pixel rendered exactly once per sweep)."""
    img_full, _, _ = run_jax(cornellish_objects(), w=25, h=19, bounces=1,
                             frames=3, tile_size=1)
    img_tiled, _, _ = run_jax(cornellish_objects(), w=25, h=19, bounces=1,
                              frames=3, tile_size=4)
    assert rmse(img_full, img_tiled) < 1e-6


def test_oversized_tile_size_raises():
    cfg = RenderConfig(width=24, height=20, tile_size=25)
    scene = Scene(cornellish_objects())
    with pytest.raises(ValueError):
        Renderer(scene, cfg)


def test_lambertian_toggle_no_recompile():
    """The L key flips a traced uniform (reference main.py:353-360): both
    modes must run through ONE compiled step and match their per-mode
    compiled references."""
    img_on, _, _ = run_jax(cornellish_objects(), bounces=2, lambertian=True)
    img_off, _, _ = run_jax(cornellish_objects(), bounces=2, lambertian=False)

    cfg = RenderConfig(width=24, height=20, bounces=2, traversal="brute",
                       lambertian=True)
    scene = Scene(cornellish_objects())
    r = Renderer(scene, cfg)
    pos, cam_dir = make_camera_for_test()
    cam = make_camera(pos, cam_dir)
    st = r.step(r.init_state(), cam, lambertian=True)
    a = np.asarray(st.accum)
    st = r.step(r.init_state(), cam, lambertian=False)  # same compiled fn
    b = np.asarray(st.accum)
    assert rmse(a, img_on) < 1e-6
    assert rmse(b, img_off) < 1e-6


def test_no_bvh_scene_forces_brute_and_matches():
    # Scene(build_bvh=False) has one giant pseudo-leaf; auto must fall back
    # to brute force (leaf loops bounded by max_leaf_tris would silently
    # skip triangles), and explicit non-brute traversal must refuse.
    objs = cornellish_objects()
    cfg = RenderConfig(width=16, height=16, bounces=1, traversal="auto")
    r = Renderer(Scene(objs, build_bvh=False), cfg)
    assert r.traversal == "brute"
    pos, cam_dir = make_camera_for_test()
    img_nb = r.image(r.render(camera=make_camera(pos, cam_dir), frames=1))
    img_ref, _, _ = run_jax(objs, w=16, h=16, bounces=1, traversal="bvh")
    assert rmse(img_nb, img_ref) < 1e-6

    # A LARGE unpartitioned pseudo-leaf must refuse non-brute traversal
    # (its leaf loop would unroll thousands of iterations).
    import numpy as np

    rngen = np.random.default_rng(0)
    big = rngen.uniform(-5, 5, size=(1500, 3, 3)).astype(np.float32)
    big_scene = Scene([Triangles(big, color=(1, 1, 1))], build_bvh=False)
    with pytest.raises(ValueError):
        Renderer(big_scene, RenderConfig(width=16, height=16, traversal="packet"))


def test_effective_max_leaf_covers_big_leaves():
    # Scene built with bigger leaves than the config assumes must still
    # test every triangle (the leaf bound follows the scene, not the config)
    objs = cornellish_objects()
    scene = Scene(objs, max_leaf_tris=48)
    cfg = RenderConfig(width=16, height=16, bounces=1, traversal="packet",
                       max_leaf_tris=8)
    r = Renderer(scene, cfg)
    pos, cam_dir = make_camera_for_test()
    img = r.image(r.render(camera=make_camera(pos, cam_dir), frames=1))
    img_ref, _, _ = run_jax(objs, w=16, h=16, bounces=1, traversal="brute")
    assert rmse(img, img_ref) < 1e-6


@pytest.mark.slow
def test_frames_per_step_matches_sequential():
    """Frame batching (frames_per_step=4): one fused step converges 4
    progressive frames with the per-frame RNG streams, so the image
    matches 4 sequential steps to float associativity (the running mean
    regroups as (f0+..+f3)/4)."""
    objs = cornellish_objects()
    img4, _, _ = run_jax(objs, frames=4, traversal="bvh", frames_per_step=4)
    img1, _, _ = run_jax(objs, frames=4, traversal="bvh")
    assert rmse(img4, img1) < 1e-6

    with pytest.raises(ValueError):
        run_jax(objs, frames=3, traversal="bvh", frames_per_step=2)


@pytest.mark.slow
def test_frames_per_step_with_tiles():
    """frames_per_step composes with remainder tiles on the reordering
    packet path."""
    objs = cornellish_objects()
    img, _, _ = run_jax(objs, frames=2, traversal="packet", frames_per_step=2,
                        tile_size=3)
    ref, _, _ = run_jax(objs, frames=2, traversal="packet")
    assert rmse(img, ref) < 1e-6


@pytest.mark.slow
def test_sort_cadence_bit_identical():
    """sort_every > 1 thins the reorder cadence but the sort + restore are
    permutations carrying all per-ray state, so images are identical."""
    objs = cornellish_objects()
    a, _, _ = run_jax(objs, frames=1, bounces=4, traversal="packet",
                      sort_every=2)
    b, _, _ = run_jax(objs, frames=1, bounces=4, traversal="packet")
    np.testing.assert_array_equal(a, b)


def test_seed_reconstruction_bit_identical(monkeypatch):
    """The reorder sort's seed column can be recomputed from the sorted
    original index (alive rays hit every bounce, so their draw count is
    static); images must be bit-identical to the carried-seed path."""
    import opengl_raytracer_tpu.renderer as rmod

    objs = cornellish_objects()
    # w=24, h=20 disables the packet path's 8x16 block permutation, so the
    # affine seed reconstruction is active by default.
    a, _, _ = run_jax(objs, frames=2, bounces=3, traversal="packet")

    orig_rf = rmod.render_flat

    def rf_norecon(*args, recon=None, **kw):
        return orig_rf(*args, recon=None, **kw)

    monkeypatch.setattr(rmod, "render_flat", rf_norecon)
    b, _, _ = run_jax(objs, frames=2, bounces=3, traversal="packet")
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_seed_reconstruction_frames_per_step(monkeypatch):
    """Seed reconstruction under frame batching (F > 1): the frame number
    becomes g // n_band in the closure — must stay bit-identical."""
    import opengl_raytracer_tpu.renderer as rmod

    objs = cornellish_objects()
    a, _, _ = run_jax(objs, frames=2, bounces=2, traversal="packet",
                      frames_per_step=2)

    orig_rf = rmod.render_flat

    def rf_norecon(*args, recon=None, **kw):
        return orig_rf(*args, recon=None, **kw)

    monkeypatch.setattr(rmod, "render_flat", rf_norecon)
    b, _, _ = run_jax(objs, frames=2, bounces=2, traversal="packet",
                      frames_per_step=2)
    np.testing.assert_array_equal(a, b)
