"""Profiling & timing utilities.

The reference's only instrumentation is wall-clock prints (BVH build time
scene.py:139-143, per-frame fps in the caption main.py:405-407).  Here:
a timer that fences on device work with ``jax.block_until_ready``, and a
wrapper around ``jax.profiler`` for real device traces.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of each visible NVIDIA card, one per line, as
    ``nvidia-smi`` reports them.  A card may be set below its top power
    limit and then runs slower under load, so every device timing is
    reported beside this line.  Raises OSError or CalledProcessError where
    there is no ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


@contextlib.contextmanager
def timer(label: str = "", sync_on=None, results: dict | None = None):
    """Wall-clock a block; if sync_on is given, waits for it on the device
    before reading the clock."""
    t0 = time.time()
    yield
    if sync_on is not None:
        jax.block_until_ready(sync_on)
    dt = time.time() - t0
    if results is not None:
        results[label] = dt
    if label:
        print(f"[timer] {label}: {dt * 1000:.1f} ms")


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace for TensorBoard / Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class FrameStats:
    """Running fps / frame-time tracker (the reference's caption metrics,
    main.py:405-428, as a reusable object)."""

    def __init__(self):
        self.last = time.time()
        self.delta = 0.0
        self.fps = 0.0
        self.frames = 0

    def tick(self) -> None:
        now = time.time()
        self.delta = now - self.last
        self.fps = 1.0 / self.delta if self.delta > 0 else 0.0
        self.last = now
        self.frames += 1

    def caption(self, frame_count: int, total: str) -> str:
        return (
            f"Fps: {round(self.fps)} Frame: {frame_count} "
            f"Frame render time: {round(self.delta * 1000)}ms "
            f"Total render time: {total}"
        )
