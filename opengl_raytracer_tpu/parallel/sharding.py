"""Multi-chip rendering: SPMD over a jax.sharding.Mesh.

The reference is a single-process, single-GPU program (SURVEY.md section 2);
its only parallelism is the implicit SIMT fan-out of fragments.  This
framework scales the same workload across devices with two mesh axes:

* ``dp`` (data/pixel parallel): the rays of the current tile band are
  sharded by band rows, and the accumulation buffer by image rows.  Scene
  arrays are small (a few MB) and replicated, so per-device rendering needs
  no communication; only the band -> accumulation merge reshards (an
  all-to-all sized one tile band, inserted by GSPMD).
* ``sp`` (sample/frame parallel): each device along ``sp`` renders a
  *different progressive frame number* (frame_count + sp_index) and the
  results are averaged with a ``psum``.  Because the reference's
  per-pixel RNG stream is seeded by (x, y, frameNumber)
  (fragment.glsl:390), frame-parallelism preserves the exact per-frame
  sample streams — S devices converge the accumulation S frames per step with
  bit-identical samples to S sequential steps.

Tile scheduling (reference main.py:409-418) composes with both axes: one
step renders one tile band across the whole mesh, so ``ShardedRenderer``
has the same ``init_state()/step()/render()/image()`` surface as the
single-chip ``Renderer`` and shares its ``RenderState`` (and therefore
``utils.checkpoint`` — see ``restore_state``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from opengl_raytracer_tpu.renderer import (
    RenderState,
    make_raycast_fn,
    render_flat,
    resolve_leaf_bound,
    select_traversal,
)
from opengl_raytracer_tpu.utils.config import RenderConfig


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              sp: int | None = None, devices=None) -> Mesh:
    """Build a (dp, sp) device mesh. Defaults: sp = 2 when the device count
    is even and > 1, else 1; dp = remaining."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} "
                f"available on platform {devices[0].platform}"
            )
        devices = devices[:n_devices]
    n = len(devices)
    if sp is None:
        sp = 2 if (dp is None and n % 2 == 0 and n > 1) else 1
    if dp is None:
        if n % sp:
            raise ValueError(f"sp={sp} does not divide device count {n}")
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    return Mesh(np.asarray(devices).reshape(dp, sp), ("dp", "sp"))


def sharded_tile_step(scene, camera, accum, frame_count, tile_x, tile_y,
                      sky_brightness, jitter_amount, lambertian, *,
                      config: RenderConfig, traversal: str, mesh: Mesh):
    """One multi-chip progressive step: renders one tile band (rows sharded
    over ``dp``, ``sp`` frame numbers summed with a psum) and folds it into
    the row-sharded accumulation buffer.

    The tile/band window math (clamp + remainder mask) is identical to the
    single-chip ``_tile_step`` — the reference's per-pixel modulo gating
    (fragment.glsl:382-386) — so images match the sequential renderer
    exactly.
    """
    H, W = config.height, config.width
    tw, th = config.tile_w, config.tile_h
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]

    raycast_fn = make_raycast_fn(scene, config, traversal)

    col0 = jnp.minimum(tile_x * tw, W - tw)
    py0 = jnp.minimum(tile_y * th, H - th)
    dx0 = tile_x * tw - col0
    dy0 = tile_y * th - py0
    px = col0 + jnp.broadcast_to(
        jnp.arange(tw, dtype=jnp.int32)[None, :], (th, tw))
    py = py0 + jnp.broadcast_to(
        jnp.arange(th, dtype=jnp.int32)[:, None], (th, tw))
    px = px.reshape(-1)
    py = py.reshape(-1)

    def local_band(scene, camera, px, py, frame_count, sky, jit_amt, lam):
        sp_idx = jax.lax.axis_index("sp")
        frame = frame_count + sp_idx
        # Seed-reconstruction descriptor (render_pixels): each dp shard is
        # a contiguous slice of the row-major band, so the pixel assignment
        # stays an arithmetic function of (shard base + local ray index).
        # The sharded path forbids frames_per_step > 1 (sp replaces it), so
        # the F branch in the closure never fires.
        recon = None
        if config.rays_per_pixel == 1:
            base0 = jax.lax.axis_index("dp") * jnp.int32(px.shape[0])
            recon = (base0, col0, py0, jnp.int32(tw),
                     jnp.int32(th * tw), jnp.asarray(frame, jnp.int32))
        colors = render_flat(scene, config, camera, frame, sky, jit_amt,
                             lam, px, py, raycast_fn, traversal, recon=recon)
        return jax.lax.psum(colors, "sp")

    # check_vma=False: the traversal while_loop initializes its carries from
    # constants, which JAX's varying-axis tracking would otherwise reject.
    band = jax.shard_map(
        local_band,
        mesh=mesh,
        in_specs=(P(), P(), P("dp"), P("dp"), P(), P(), P(), P()),
        out_specs=P("dp"),
        check_vma=False,
    )(scene, camera, px, py, frame_count,
      sky_brightness, jitter_amount, lambertian)

    # GL py ascends bottom-up; accum rows descend top-down.
    tile_img = band.reshape(th, tw, 3)[::-1]
    row0 = H - py0 - th
    valid = ((jnp.arange(tw, dtype=jnp.int32)[None, :] >= dx0)
             & (jnp.arange(th, dtype=jnp.int32)[:, None] >= dy0))
    mask_img = valid[::-1][:, :, None]

    prev = jax.lax.dynamic_slice(accum, (row0, col0, 0), (th, tw, 3))
    fc = frame_count.astype(jnp.float32)
    merged = jnp.where(mask_img, (prev * fc + tile_img) / (fc + sp), prev)
    return jax.lax.dynamic_update_slice(accum, merged, (row0, col0, 0))


class ShardedRenderer:
    """Progressive renderer over a device mesh, with the single-chip
    ``Renderer``'s state/step/render surface.

    Each ``step`` renders one tile band and advances the accumulation by
    ``sp`` frames (``frames_per_step``); a full tile sweep therefore
    converges ``sp`` frames.  ``RenderState`` round-trips through
    ``utils.checkpoint`` — use :meth:`restore_state` after loading to
    re-shard the accumulation buffer onto the mesh.
    """

    def __init__(self, scene, config: RenderConfig, mesh: Mesh):
        from opengl_raytracer_tpu.models.scene import Scene

        scene_data = scene.send() if isinstance(scene, Scene) else scene
        config = resolve_leaf_bound(scene_data, config)
        if config.frames_per_step != 1:
            raise ValueError(
                "frames_per_step > 1 is the single-chip frame-batching "
                "path; on a mesh, use the sp axis for frame parallelism"
            )
        self.config = config
        self.mesh = mesh
        dp = mesh.shape["dp"]
        if config.height % dp:
            raise ValueError(f"dp={dp} must divide height {config.height}")
        if config.tile_h % dp:
            raise ValueError(
                f"dp={dp} must divide the tile band height {config.tile_h} "
                f"(tile_size={config.tile_size})"
            )
        # Per-device ray shards need not be a multiple of 128: render_flat
        # pads each device's chunk to whole packets and discards the pad.
        self.traversal = select_traversal(scene_data, config)
        self.frames_per_step = mesh.shape["sp"]

        repl = NamedSharding(mesh, P())
        self.scene = jax.device_put(scene_data, repl)
        self._accum_sharding = NamedSharding(mesh, P("dp"))
        self._step = jax.jit(
            partial(sharded_tile_step, config=config,
                    traversal=self.traversal,
                    mesh=mesh),
            donate_argnums=(2,),
        )

    def init_state(self) -> RenderState:
        accum = jax.device_put(
            jnp.zeros((self.config.height, self.config.width, 3), jnp.float32),
            self._accum_sharding,
        )
        return RenderState(accum=accum)

    def restore_state(self, state: RenderState) -> RenderState:
        """Re-shard a (host/checkpoint-loaded) state's accumulation onto the
        mesh so stepping resumes with device-resident buffers."""
        return RenderState(
            accum=jax.device_put(state.accum, self._accum_sharding),
            frame_count=state.frame_count,
            tile_x=state.tile_x,
            tile_y=state.tile_y,
            total_frames=state.total_frames,
        )

    def reset(self, state: RenderState) -> RenderState:
        return RenderState(accum=jnp.zeros_like(state.accum))

    def step(self, state: RenderState, camera,
             sky_brightness: float | None = None,
             jitter_amount: float | None = None,
             lambertian: bool | None = None) -> RenderState:
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
                frames += self.frames_per_step
        return RenderState(
            accum=accum,
            frame_count=frames,
            tile_x=tile_x,
            tile_y=tile_y,
            total_frames=state.total_frames + 1,
        )

    def render(self, camera=None, frames: int = 1,
               state: RenderState | None = None) -> RenderState:
        """Run enough sweeps to converge ``frames`` progressive frames."""
        if camera is None:
            from opengl_raytracer_tpu.presets import (
                DEFAULT_CAM_DIR,
                DEFAULT_CAM_POS,
            )
            from opengl_raytracer_tpu.ops.camera import make_camera

            camera = make_camera(DEFAULT_CAM_POS, DEFAULT_CAM_DIR)
        if state is None:
            state = self.init_state()
        if frames % self.frames_per_step:
            raise ValueError(
                f"frames={frames} must be a multiple of sp="
                f"{self.frames_per_step} (each sweep converges sp frames)"
            )
        tiles = self.config.num_tiles_x * self.config.num_tiles_y
        for _ in range((frames // self.frames_per_step) * tiles):
            state = self.step(state, camera)
        return state

    @staticmethod
    def image(state: RenderState) -> np.ndarray:
        return np.asarray(state.accum)
