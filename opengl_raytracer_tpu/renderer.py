"""Progressive tile renderer: the jit-compiled core of the framework.

Replaces the reference's GL plumbing — fragment dispatch over a fullscreen
quad, RGBA32F ping-pong FBO accumulation, per-tile draw calls (reference:
main.py:273-430, screen.py:37-52, fragment.glsl:376-416) — with a single
pure function per tile step:

    accum' = step(scene, camera, accum, frame_count, tile_x, tile_y, ...)

* The per-pixel work (seed, warm-up, angle-linear ray, jitter, trace) follows
  fragment.glsl ``main()`` exactly (fragment.glsl:376-407).
* Progressive accumulation is the running mean
  ``(prev * frameNumber + curr) / (frameNumber + 1)``
  (fragment.glsl:409-414); functional double-buffering makes the reference's
  read-write hazard (main.py:389) structurally impossible.
* The tile scheduler renders one ``(W/tiles) x (H/tiles)`` band per step and
  the frame counter increments after a full sweep (main.py:409-418,
  fragment.glsl:382-386).  Remainder tiles (any ``tile_size``) are handled
  by clamping the band window into the frame and masking the merge — the
  functional analog of the reference's per-pixel modulo gating
  (fragment.glsl:382, main.py:156-157).
* Rays are chunked into coherent row bands inside the step (``lax.map``), so
  BVH-traversal divergence is bounded per chunk and peak memory stays flat.

The accumulation buffer is donated, so progressive rendering updates HBM in
place.  ``accum`` is stored top-row-first; ray generation converts to the
reference's GL bottom-up pixel coordinates for seed/uv parity.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from opengl_raytracer_tpu.models.scene import Scene, SceneData
from opengl_raytracer_tpu.ops import rng
from opengl_raytracer_tpu.ops.camera import (Camera, make_camera, pixel_uv,
                                             ray_dirs_soa)
from opengl_raytracer_tpu.ops.integrator import trace
from opengl_raytracer_tpu.ops.intersect import raycast_brute
from opengl_raytracer_tpu.ops.traversal import PACKET, raycast_bvh, raycast_packet
from opengl_raytracer_tpu.utils.config import RenderConfig, SKY_COLOR

_BRUTE_MAX_TRIS = 128  # "auto" switches to BVH packet traversal above this
_MAX_LEAF_UNROLL = 1024  # largest BVH leaf the traversal loops may unroll

_DEFAULT_CHUNK = 128 * 1024  # rays per render_flat chunk (config.ray_chunk=0)
_BLOCK_H, _BLOCK_W = 8, 16  # coherent 128-ray packet tile (8 rows x 16 cols)


def effective_max_leaf(scene, config: RenderConfig) -> int:
    """Leaf-loop bound actually required by this scene's BVH.

    Derived from the scene's OWN node table — never from
    ``config.max_leaf_tris`` (which is only the *build* parameter).  A
    config bound smaller than the scene's largest leaf would silently skip
    triangles; a larger one would only add masked leaf iterations.  Must
    be called on CONCRETE scene data (at renderer construction), never
    under jit — the result is baked into the compiled leaf loops as a
    static.
    """
    del config
    return int(np.asarray(scene.node_count).max()) if scene.node_count.size else 1


def resolve_leaf_bound(scene, config: RenderConfig) -> RenderConfig:
    """Return config with max_leaf_tris set to the scene's actual bound."""
    import dataclasses

    eff = effective_max_leaf(scene, config)
    if eff != config.max_leaf_tris:
        config = dataclasses.replace(config, max_leaf_tris=eff)
    return config


def select_traversal(scene, config: RenderConfig) -> str:
    """The traversal a renderer runs for this scene and config.

    ``"auto"`` picks brute force for scenes of at most 128 triangles and
    the packet BVH traversal above that, or brute force again when the
    scene's BVH has a leaf over 1024 triangles (``Scene(build_bvh=False)``
    makes one pseudo-leaf of the whole scene, and the leaf loop would
    unroll that many times).  An explicit BVH traversal on such a scene
    raises instead.  Must be called on CONCRETE scene data."""
    traversal = config.traversal
    if traversal == "auto":
        traversal = "brute" if scene.num_tris <= _BRUTE_MAX_TRIS else "packet"
    if (traversal != "brute"
            and effective_max_leaf(scene, config) > _MAX_LEAF_UNROLL):
        if config.traversal != "auto":
            raise ValueError(
                f"scene has BVH leaves over {_MAX_LEAF_UNROLL} triangles "
                f"(was it built with build_bvh=False?); use traversal='brute'")
        traversal = "brute"
    return traversal


def make_raycast_fn(scene, config: RenderConfig, traversal: str):
    """Bind a raycast(o3, d3, active) -> Nearest for the chosen traversal
    strategy; the integrator passes ray components as SoA 3-tuples of
    (R,) columns (ops/integrator.py docstring).  ``config.max_leaf_tris``
    must already cover the scene's largest leaf (see resolve_leaf_bound).
    """
    if traversal == "brute":
        base = partial(raycast_brute, scene)
    elif traversal == "bvh":
        base = partial(raycast_bvh, scene, max_leaf_tris=config.max_leaf_tris)
    elif traversal == "packet":
        base = partial(raycast_packet, scene,
                       max_leaf_tris=config.max_leaf_tris)
    else:
        raise ValueError(f"unknown traversal {traversal!r}")

    def fn(origin, direction, active=None):
        if isinstance(origin, (tuple, list)):
            origin = jnp.stack(origin, axis=-1)
        if isinstance(direction, (tuple, list)):
            direction = jnp.stack(direction, axis=-1)
        return base(origin, direction, active)

    return fn


@dataclasses.dataclass
class RenderState:
    """Resumable render state: the functional analog of the reference's
    (accum FBO pair, frame_count, tile cursor) (screen.py:65-66,
    main.py:282)."""

    accum: jnp.ndarray  # (H, W, 3) float32, top row first
    frame_count: int = 0
    tile_x: int = 0
    tile_y: int = 0
    total_frames: int = 0  # tile draws issued (reference main.py:276)


def render_pixels(scene: SceneData, config: RenderConfig, camera: Camera,
                  frame_number, sky_brightness, jitter_amount, lambertian,
                  px, py, raycast_fn, reorder: bool = False, recon=None):
    """Trace a flat batch of pixels; px/py int32 (R,), py in GL convention
    (0 = bottom row).  Returns (R, 3) linear color.

    ``recon`` (optional) describes this batch's pixel assignment as an
    arithmetic function of the ray index: ``(base, col0, py0, band_w,
    n_band, frame0)`` with ``g = base + i``; ``frame = frame0 +
    g // n_band`` and ``g %= n_band`` under frame batching; ``px = col0 +
    g % band_w``, ``py = py0 + g // band_w``.  When given (and
    rays_per_pixel == 1), the integrator's reorder sorts drop their seed
    column and recompute the RNG state from the sorted original index
    instead — the state is the per-pixel seed advanced a static number of
    draws (3 warm-ups + 2 jitter draws here + 3 per completed bounce),
    and the LCG advance composes in closed form (rng.advance_n)."""
    seed = rng.seed_pixels(px, py, frame_number)
    seed = rng.warmup(seed, 3)

    seed_recon = None
    if recon is not None and config.rays_per_pixel == 1:
        base, col0, py0, band_w, n_band, frame0 = recon

        def seed_recon(orig, n_draws):
            g = base + orig
            if config.frames_per_step > 1:
                frame = frame0 + g // n_band
                g = g % n_band
            else:
                frame = frame0
            rpx = col0 + g % band_w
            rpy = py0 + g // band_w
            s = rng.seed_pixels(rpx, rpy, frame)
            return rng.advance_n(s, 5 + n_draws)

    u, v = pixel_uv(px, py, config.width, config.height)
    d = ray_dirs_soa(camera, u, v, config.width, config.height,
                     aspect=config.ray_aspect)

    # Anti-alias jitter (fragment.glsl:398-400).  SoA columns throughout
    # (see the ops/integrator.py docstring).
    seed, r1 = rng.random_value(seed)
    seed, r2 = rng.random_value(seed)
    d = tuple(
        d[a] + (camera.right[a] * r1 + camera.up[a] * r2) * jitter_amount
        for a in range(3)
    )
    d_len = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    d = tuple(d[a] / d_len for a in range(3))

    origin = tuple(jnp.broadcast_to(camera.pos[a], d[0].shape)
                   for a in range(3))
    sky = jnp.asarray(SKY_COLOR, jnp.float32) * sky_brightness

    color, _ = trace(
        scene,
        raycast_fn,
        origin,
        d,
        seed,
        sky,
        n_bounces=config.n_bounces,
        rays_per_pixel=config.rays_per_pixel,
        lambertian=lambertian,
        reorder=reorder,
        sort_every=config.sort_every,
        seed_recon=seed_recon,
    )
    return color


def render_flat(scene: SceneData, config: RenderConfig, camera: Camera,
                frame_count, sky_brightness, jitter_amount, lambertian,
                px, py, raycast_fn, traversal: str, recon=None):
    """Chunked render of a flat pixel list -> (R, 3) colors.

    ``recon``: optional ``(base0, col0, py0, band_w, n_band, frame0)``
    seed reconstruction descriptor (see render_pixels); ``base0`` is the
    caller's ray-index offset (0 single-chip; the shard offset under dp
    sharding) and the per-chunk base is added here.

    Every path carries per-ray state in device memory, so chunks of
    ``config.ray_chunk`` rays (default 128K) bound peak memory.
    """
    R = px.shape[0]
    chunk = min(config.ray_chunk or _DEFAULT_CHUNK, R)
    if traversal == "packet":
        chunk = -(-chunk // PACKET) * PACKET  # round up to whole packets
    n_chunks = -(-R // chunk)
    pad = n_chunks * chunk - R

    # frame_count may be per-ray (frames_per_step batching): chunk it along
    # with the pixels so each chunk sees its rays' frame numbers.
    frame_is_array = jnp.ndim(frame_count) > 0
    if pad:
        px = jnp.concatenate([px, jnp.zeros((pad,), jnp.int32)])
        py = jnp.concatenate([py, jnp.zeros((pad,), jnp.int32)])
        if frame_is_array:
            frame_count = jnp.concatenate(
                [frame_count, jnp.zeros((pad,), frame_count.dtype)])

    def body(px_c, py_c, frame_c, base=None):
        rec = None
        if recon is not None:
            b = recon[0] + (jnp.int32(0) if base is None else base)
            rec = (b,) + tuple(recon[1:])
        return render_pixels(
            scene, config, camera, frame_c, sky_brightness, jitter_amount,
            lambertian, px_c, py_c, raycast_fn=raycast_fn,
            reorder=traversal == "packet", recon=rec,
        )

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * jnp.int32(chunk)
    if n_chunks == 1:
        colors = body(px, py, frame_count)
    elif frame_is_array:
        colors = jax.lax.map(
            lambda xs: body(xs[0], xs[1], xs[2], xs[3]),
            (px.reshape(n_chunks, chunk), py.reshape(n_chunks, chunk),
             frame_count.reshape(n_chunks, chunk), bases),
        ).reshape(-1, 3)
    else:
        colors = jax.lax.map(
            lambda xs: body(xs[0], xs[1], frame_count, xs[2]),
            (px.reshape(n_chunks, chunk), py.reshape(n_chunks, chunk),
             bases),
        ).reshape(-1, 3)
    return colors[:R]


def _tile_step(scene: SceneData, camera: Camera, accum, frame_count,
               tile_x, tile_y, sky_brightness, jitter_amount, lambertian,
               *, config: RenderConfig, traversal: str):
    """Render one tile and fold it into the accumulation buffer."""
    H, W = config.height, config.width
    tw, th = config.tile_w, config.tile_h

    raycast_fn = make_raycast_fn(scene, config, traversal)

    # Pixel grids for this tile, GL convention.  Remainder tiles (tile_size
    # not dividing the frame — the reference handles these via per-pixel
    # modulo gating, fragment.glsl:382-386 + main.py:156-157): the band
    # window is clamped to stay inside the frame, so its leading rows/cols
    # re-render pixels belonging to the previous tile; the merge below
    # masks those out.  When tiles divide exactly the clamp and the mask
    # are no-ops.
    col0 = jnp.minimum(tile_x * tw, W - tw)
    py0 = jnp.minimum(tile_y * th, H - th)
    dx0 = tile_x * tw - col0  # band cols < dx0 belong to the previous tile
    dy0 = tile_y * th - py0
    px = col0 + jnp.broadcast_to(jnp.arange(tw, dtype=jnp.int32)[None, :], (th, tw))
    py = py0 + jnp.broadcast_to(jnp.arange(th, dtype=jnp.int32)[:, None], (th, tw))

    # Packet mode wants spatially coherent ray packets: reorder pixels into
    # 8x16 blocks so each group of 128 consecutive rays is one screen tile.
    use_blocks = (
        traversal == "packet" and th % _BLOCK_H == 0 and tw % _BLOCK_W == 0
    )
    if use_blocks:
        def to_blocks(a):
            return (
                a.reshape(th // _BLOCK_H, _BLOCK_H, tw // _BLOCK_W, _BLOCK_W)
                .transpose(0, 2, 1, 3)
                .reshape(-1)
            )
        px, py = to_blocks(px), to_blocks(py)
    else:
        px, py = px.reshape(-1), py.reshape(-1)

    # Frame batching (frames_per_step = F > 1): replicate the tile's rays F
    # times, seed copy s with frame number frame_count + s, and fold the
    # SUM into the running mean with weight F.  Per-sample RNG streams are
    # exactly the per-frame streams (seeding is (x, y, frameNumber),
    # fragment.glsl:390), so one fused step converges F progressive frames
    # while paying the sort / glue / dispatch fixed costs once.
    F = config.frames_per_step
    n_band = px.shape[0]
    if F > 1:
        px = jnp.tile(px, F)
        py = jnp.tile(py, F)
        frame_arr = (frame_count
                     + jnp.repeat(jnp.arange(F, dtype=jnp.int32), n_band))
    else:
        frame_arr = frame_count

    # Seed-reconstruction descriptor: the band's pixel assignment is an
    # arithmetic function of the ray index (row-major band + F-fold frame
    # repeat), so the integrator's reorder sorts can drop the seed column
    # (render_pixels docstring).  The packet path's 8x16 block permutation
    # breaks the affine form, so it keeps the carried seed.
    recon = None
    if not use_blocks and config.rays_per_pixel == 1:
        recon = (jnp.int32(0), col0, py0, jnp.int32(tw), jnp.int32(n_band),
                 jnp.asarray(frame_count, jnp.int32))

    colors = render_flat(scene, config, camera, frame_arr, sky_brightness,
                         jitter_amount, lambertian, px, py, raycast_fn,
                         traversal, recon=recon)
    if F > 1:
        colors = colors.reshape(F, n_band, 3).sum(axis=0)
    if use_blocks:
        colors = (
            colors.reshape(th // _BLOCK_H, tw // _BLOCK_W, _BLOCK_H, _BLOCK_W, 3)
            .transpose(0, 2, 1, 3, 4)
            .reshape(th, tw, 3)
        )
    else:
        colors = colors.reshape(th, tw, 3)

    # GL py ascends bottom-up; accum rows descend top-down.
    tile_img = colors[::-1]
    row0 = H - py0 - th

    # Remainder-tile mask: band positions below the tile's true origin were
    # re-rendered only because of the window clamp — keep prev there.
    valid = ((jnp.arange(tw, dtype=jnp.int32)[None, :] >= dx0)
             & (jnp.arange(th, dtype=jnp.int32)[:, None] >= dy0))
    mask_img = valid[::-1][:, :, None]

    prev = jax.lax.dynamic_slice(accum, (row0, col0, 0), (th, tw, 3))
    fc = frame_count.astype(jnp.float32)
    merged = jnp.where(mask_img, (prev * fc + tile_img) / (fc + F), prev)
    return jax.lax.dynamic_update_slice(accum, merged, (row0, col0, 0))


class Renderer:
    """Owns the compiled tile step and the host-side tile/frame bookkeeping
    (the reference's App.main loop, main.py:273-430, minus windowing)."""

    def __init__(self, scene, config: RenderConfig = RenderConfig()):
        if isinstance(scene, Scene):
            scene_data = scene.send()
        else:
            scene_data = scene
        self.scene = scene_data
        config = resolve_leaf_bound(scene_data, config)
        self.config = config

        if config.tile_w < 1 or config.tile_h < 1:
            # the reference divides by tileSizeX and would crash too
            # (main.py:125-126, :156-157)
            raise ValueError(
                f"tile_size={config.tile_size} exceeds the frame "
                f"({config.width}x{config.height})"
            )

        self.traversal = select_traversal(scene_data, config)

        self._step = jax.jit(
            partial(_tile_step, config=config, traversal=self.traversal),
            donate_argnums=(2,),
        )

    def init_state(self) -> RenderState:
        accum = jnp.zeros((self.config.height, self.config.width, 3), jnp.float32)
        return RenderState(accum=accum)

    def reset(self, state: RenderState) -> RenderState:
        """Zero the accumulation and counters (reference resetFrames,
        main.py:252-271)."""
        return RenderState(accum=jnp.zeros_like(state.accum))

    def step(self, state: RenderState, camera: Camera,
             sky_brightness: float | None = None,
             jitter_amount: float | None = None,
             lambertian: bool | None = None) -> RenderState:
        """One tile draw + tile cursor advance (main.py:375-418).

        ``lambertian`` is traced (uniform-flip semantics, main.py:353-360):
        toggling it does NOT recompile the step.
        """
        cfg = self.config
        sky = cfg.sky_brightness if sky_brightness is None else sky_brightness
        jit_amt = cfg.jitter_amount if jitter_amount is None else jitter_amount
        lam = cfg.lambertian if lambertian is None else lambertian

        accum = self._step(
            self.scene, camera, state.accum,
            jnp.int32(state.frame_count),
            jnp.int32(state.tile_x), jnp.int32(state.tile_y),
            jnp.float32(sky), jnp.float32(jit_amt), jnp.asarray(lam, bool),
        )

        tile_x, tile_y, frames = state.tile_x + 1, state.tile_y, state.frame_count
        if tile_x >= cfg.num_tiles_x:
            tile_x = 0
            tile_y += 1
            if tile_y >= cfg.num_tiles_y:
                tile_y = 0
                frames += cfg.frames_per_step
        return RenderState(
            accum=accum,
            frame_count=frames,
            tile_x=tile_x,
            tile_y=tile_y,
            total_frames=state.total_frames + 1,
        )

    def render(self, camera: Camera | None = None, frames: int = 1,
               state: RenderState | None = None,
               cam_pos=None, cam_dir=None) -> RenderState:
        """Run `frames` full progressive sweeps and return the state."""
        if camera is None:
            from opengl_raytracer_tpu.presets import DEFAULT_CAM_DIR, DEFAULT_CAM_POS

            camera = make_camera(
                cam_pos if cam_pos is not None else DEFAULT_CAM_POS,
                cam_dir if cam_dir is not None else DEFAULT_CAM_DIR,
            )
        if state is None:
            state = self.init_state()
        F = self.config.frames_per_step
        if frames % F:
            raise ValueError(
                f"frames={frames} must be a multiple of frames_per_step={F} "
                f"(each sweep converges {F} frames)"
            )
        tiles = self.config.num_tiles_x * self.config.num_tiles_y
        for _ in range((frames // F) * tiles):
            state = self.step(state, camera)
        return state

    @staticmethod
    def image(state: RenderState) -> np.ndarray:
        """Accumulated frame as (H, W, 3) float32, top row first."""
        return np.asarray(state.accum)
