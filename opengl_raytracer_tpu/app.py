"""Interactive / headless application driver.

API-compatible rebuild of the reference's ``App`` (reference: main.py:16):
``App(window_size, screen_size, bounces, rays_per_pixel, jitter_amount,
lambertian, skyIllumination, tileSize)`` authors the default scene
(main.py:19-111), then runs the frame loop — but instead of a GL context,
shaders, and SSBO uploads, it owns a jit-compiled :class:`Renderer` and a
numpy framebuffer blitted to a pygame window.

Behavior preserved from the reference's loop (main.py:273-430):

* WASD/QE fly camera scaled by ``speed``; mouse look scaled by
  ``sensitivity``; gated by the M toggle (main.py:292-351);
* L toggles lambertian shading and resets accumulation (main.py:353-360);
* C prints the camera pose (main.py:362-365); R snaps rotation to 5
  degrees (main.py:367-370); ESC quits;
* any movement re-derives the camera basis and resets the progressive
  accumulation (resetFrames, main.py:252-271);
* the caption shows fps / frame count / frame time / total render time
  (main.py:405-407);
* on exit, the accumulated frame is saved as ``render_<time>.png`` if the
  run lasted over 10 minutes (main.py:432-439).

Headless operation (no display): pass ``headless=True`` (or run without a
display server) and the loop renders ``max_frames`` progressive frames and
saves the result.
"""

from __future__ import annotations

import os
import time

import numpy as np

from opengl_raytracer_tpu.models.scene import Scene
from opengl_raytracer_tpu.ops.camera import Camera, camera_basis, make_camera
from opengl_raytracer_tpu.presets import (
    DEFAULT_CAM_DIR,
    DEFAULT_CAM_POS,
    default_objects,
)
from opengl_raytracer_tpu.renderer import Renderer
from opengl_raytracer_tpu.utils.config import RenderConfig
from opengl_raytracer_tpu.utils.image import save_png, to_uint8


class App:
    def __init__(
        self,
        window_size=(1920, 1080),
        screen_size=None,
        bounces: int = 7,
        rays_per_pixel: int = 1,
        jitter_amount: float = 0.001,
        lambertian: bool = True,
        skyIllumination: float = 1.0,
        tileSize: int = 1,
        scene: Scene | None = None,
        dragon: str | None = None,
        headless: bool | None = None,
        max_frames: int = 64,
        output: str | None = None,
        run: bool = True,
        max_leaf_tris: int | None = None,
        traversal: str | None = None,
    ):
        w, h = int(window_size[0]), int(window_size[1])
        self.screen_size = tuple(screen_size) if screen_size is not None else (w, h)
        # Ray-generation aspect comes from the DISPLAY size (reference
        # main.py:137: aspect = sw / sh), a real divergence from the render
        # aspect whenever screen_size != window_size.
        self.config = RenderConfig(
            width=w,
            height=h,
            aspect=self.screen_size[0] / self.screen_size[1],
            bounces=bounces,
            rays_per_pixel=rays_per_pixel,
            jitter_amount=jitter_amount,
            lambertian=lambertian,
            sky_brightness=skyIllumination,
            tile_size=tileSize,
            **({"max_leaf_tris": max_leaf_tris} if max_leaf_tris else {}),
            **({"traversal": traversal} if traversal else {}),
        )

        # Default scene = the reference's Cornell-box variant (main.py:19-111).
        # The BVH is built with the config's leaf bound so scene tables and
        # traversal loop bounds always agree.
        self.scene = scene if scene is not None else Scene(
            default_objects(dragon), max_leaf_tris=self.config.max_leaf_tris,
            verbose=True,
        )
        self.renderer = Renderer(self.scene, self.config)

        # Camera state (main.py:151-154).
        self.camPos = np.array(DEFAULT_CAM_POS, dtype=np.float32)
        self.camDir = np.array(DEFAULT_CAM_DIR, dtype=np.float32)
        self.speed = 1.0
        self.sensitivity = 0.1
        self.canMove = False
        self.lambertian = lambertian

        self.max_frames = max_frames
        self.output = output
        self.headless = headless if headless is not None else not self._has_display()

        self.state = self.renderer.init_state()
        self.camera = self._make_camera()
        self.time_start = time.time()

        if run:
            self.main()

    @staticmethod
    def _has_display() -> bool:
        return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
                    or os.name == "nt")

    def _make_camera(self) -> Camera:
        return make_camera(self.camPos, self.camDir)

    def get_camera_basis(self, cam_dir):
        """(right, forward, up) — reference main.py:211-237."""
        right, forward, up = camera_basis(cam_dir)
        return right, forward, up

    def get_time(self) -> str:
        """Elapsed wall-clock, reference formatting (main.py:239-250)."""
        delta = round(time.time() - self.time_start)
        h, rem = divmod(delta, 3600)
        m, s = divmod(rem, 60)
        if h > 0:
            return f"{h}h {m}m {s}s"
        if m > 0:
            return f"{m}m {s}s"
        return f"{s}s"

    def resetFrames(self) -> None:
        """Zero accumulation + counters and rebuild the camera basis
        (reference main.py:252-271)."""
        self.camera = self._make_camera()
        self.state = self.renderer.reset(self.state)
        self.time_start = time.time()

    def image(self) -> np.ndarray:
        return self.renderer.image(self.state)

    def save(self, path: str) -> None:
        save_png(path, self.image())

    def main(self) -> None:
        if self.headless:
            self._main_headless()
        else:
            self._main_interactive()

    def _main_headless(self) -> None:
        import jax

        last = time.time()
        # A full sweep is num_tiles_x * num_tiles_y steps — NOT tile_size**2:
        # remainder tiles add a band per axis (e.g. 960x540 at tileSize=7 ->
        # tile_w=137 -> 8x8 bands).  Reference semantics: main.py:409-418.
        tiles = self.config.num_tiles_x * self.config.num_tiles_y
        for f in range(self.max_frames * tiles):
            self.state = self.renderer.step(self.state, self.camera,
                                            lambertian=self.lambertian)
            if self.state.tile_x == 0 and self.state.tile_y == 0:
                jax.block_until_ready(self.state.accum)  # per-frame timing
                now = time.time()
                print(
                    f"\rFrame {self.state.frame_count}  "
                    f"{(now - last) * 1000:.0f} ms  total {self.get_time()}",
                    end="",
                    flush=True,
                )
                last = now
        np.asarray(self.state.accum)  # sync
        print()
        out = self.output or f"render_{self.get_time().replace(' ', '_')}.png"
        self.save(out)
        print(f"Saved {out}")

    def _main_interactive(self) -> None:  # pragma: no cover - needs a display
        import pygame as pg

        pg.init()
        surface = pg.display.set_mode(self.screen_size)
        pg.display.set_caption("JAX raytracer")
        running = True
        fps = 0.0
        delta_time = 0.0
        last_frame_time = time.time()
        pending = None  # (device accum snapshot, frame_count) to display

        while running:
            keys = pg.key.get_pressed()
            rel = pg.mouse.get_rel()
            delta = np.array([rel[0], -rel[1]], dtype=np.float32) * self.canMove
            self.camDir += delta * self.sensitivity

            right, forward, up = self.get_camera_basis(self.camDir)
            moved = bool(delta.any())
            move = self.speed * self.canMove
            if keys[pg.K_w]:
                self.camPos += move * forward
                moved = True
            if keys[pg.K_s]:
                self.camPos -= move * forward
                moved = True
            if keys[pg.K_d]:
                self.camPos += move * right
                moved = True
            if keys[pg.K_a]:
                self.camPos -= move * right
                moved = True
            if keys[pg.K_e]:
                self.camPos += move * up
                moved = True
            if keys[pg.K_q]:
                self.camPos -= move * up
                moved = True
            if moved:
                self.resetFrames()

            for event in pg.event.get():
                if event.type == pg.QUIT:
                    running = False
                if event.type == pg.KEYDOWN:
                    if event.key == pg.K_m:
                        self.canMove = not self.canMove
                        print("\nCan move" if self.canMove else "\nCan't move")
                        pg.mouse.set_visible(not self.canMove)
                        pg.event.set_grab(self.canMove)
                    if event.key == pg.K_l:
                        # Uniform flip, no recompile (reference main.py:353-360):
                        # lambertian is a traced argument of the render step.
                        self.lambertian = not self.lambertian
                        print(f"\nSet lambertian lighting to {self.lambertian}")
                        self.resetFrames()
                    if event.key == pg.K_c:
                        print("\nCamera info:")
                        print(f"Camera position: {self.camPos}")
                        print(f"Camera rotation: {self.camDir}")
                    if event.key == pg.K_r:
                        self.camDir = np.round(self.camDir / 5) * 5
                        self.resetFrames()
                    if event.key == pg.K_ESCAPE:
                        running = False

            self.state = self.renderer.step(self.state, self.camera,
                                            lambertian=self.lambertian)

            # Display pipelining: ``step`` only DISPATCHES device work, so
            # blit the previous sweep's snapshot now — the host-side
            # readback + uint8 + surface scale (~tens of ms at 1080p)
            # overlaps this sweep's device compute instead of serializing
            # with it.  The snapshot is a cheap on-device copy taken at
            # sweep end (the functional analog of the reference's FBO
            # ping-pong: display one buffer while the other renders,
            # main.py:375-401).
            if pending is not None:
                img_dev, frame_count = pending
                pending = None
                img = to_uint8(np.asarray(img_dev))
                frame = pg.surfarray.make_surface(img.transpose(1, 0, 2))
                frame = pg.transform.scale(frame, self.screen_size)
                surface.blit(frame, (0, 0))
                pg.display.flip()

                delta_time = time.time() - last_frame_time
                fps = 1.0 / delta_time if delta_time > 0 else 0.0
                last_frame_time = time.time()
                pg.display.set_caption(
                    f"JAX raytracer! Fps: {round(fps)} "
                    f"Frame: {frame_count} "
                    f"Frame render time: {round(delta_time * 1000)}ms "
                    f"Total render time: {self.get_time()}"
                )

            if self.state.tile_x == 0 and self.state.tile_y == 0:
                # On-device snapshot (async): the next step donates
                # state.accum, so the display reads this copy instead.
                pending = (self.state.accum + 0.0, self.state.frame_count)

        # Exit screenshot after long runs (reference main.py:432-439).
        if time.time() - self.time_start > 10 * 60:
            self.save(f"render_{self.get_time().replace(' ', '_')}.png")
        pg.quit()
