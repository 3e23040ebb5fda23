"""Benchmark harness: steady frames/s of the default scene on one GPU.

Renders the generated default scene (presets.default_objects: 27,542
triangles) at 1920x1080 with 4 bounces and 1 spp through ``Renderer`` on
the first GPU JAX finds, and prints ONE JSON line:

    {"metric": ..., "value": fps, "unit": "fps",
     "device": {"platform": ..., "kind": ..., "count": ...,
                "card": "<nvidia-smi name, power.limit>"}}

Set-up (scene build, first-step compile) goes to stderr.  The measurement
runs in a child process that a parent which never imports JAX supervises
with a timeout, so a hang cannot outlive the run; the parent exits non-zero
when the child fails.  There is no CPU fallback: without a GPU the child
fails.

Env knobs:
    OGLRT_BENCH_WIDTH/HEIGHT/BOUNCES/WARMUP/ITERS — workload and window
    OGLRT_BENCH_SPP       — frames_per_step batching; reported as
                            spp-batched frames/s (steps/s x spp)
    OGLRT_BENCH_PNG       — also save the final accumulation
    OGLRT_BENCH_TIMEOUT   — the child's time limit in seconds (1500)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _workload():
    return {
        "width": int(os.environ.get("OGLRT_BENCH_WIDTH", 1920)),
        "height": int(os.environ.get("OGLRT_BENCH_HEIGHT", 1080)),
        "bounces": int(os.environ.get("OGLRT_BENCH_BOUNCES", 4)),
        "spp": int(os.environ.get("OGLRT_BENCH_SPP", 1)),
    }


def _metric_name(w):
    spp = f", {w['spp']}-spp batched" if w["spp"] > 1 else ""
    return (f"fps at {w['width']}x{w['height']}/{w['bounces']}-bounce "
            f"on the generated default scene{spp}")


def run_bench():
    """The actual measurement (child process).  Prints the JSON line."""
    import jax

    from opengl_raytracer_tpu.models.scene import Scene
    from opengl_raytracer_tpu.ops.camera import make_camera
    from opengl_raytracer_tpu.presets import (
        DEFAULT_CAM_DIR,
        DEFAULT_CAM_POS,
        default_objects,
    )
    from opengl_raytracer_tpu.renderer import Renderer
    from opengl_raytracer_tpu.utils.config import RenderConfig
    from opengl_raytracer_tpu.utils.profiling import gpu_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r} "
                         f"({dev.device_kind})")
    card = gpu_name_and_power_limit().splitlines()[0]
    log(f"device: {dev.device_kind} x{len(jax.devices())}; card: {card}")

    w = _workload()
    warmup = int(os.environ.get("OGLRT_BENCH_WARMUP", 2))
    iters = int(os.environ.get("OGLRT_BENCH_ITERS", 8))
    config = RenderConfig(width=w["width"], height=w["height"],
                          bounces=w["bounces"], frames_per_step=w["spp"])

    t0 = time.time()
    scene = Scene(default_objects(), max_leaf_tris=config.max_leaf_tris)
    log(f"scene: {scene.total_triangles:,} tris, {scene.total_boxes:,} BVH nodes, "
        f"built in {time.time() - t0:.2f}s")
    renderer = Renderer(scene, config)
    camera = make_camera(DEFAULT_CAM_POS, DEFAULT_CAM_DIR)

    state = renderer.init_state()
    t0 = time.time()
    state = renderer.step(state, camera)
    jax.block_until_ready(state.accum)
    log(f"first step (compile+run): {time.time() - t0:.2f}s "
        f"(traversal {renderer.traversal})")

    for _ in range(warmup):
        state = renderer.step(state, camera)
    jax.block_until_ready(state.accum)

    t0 = time.time()
    for _ in range(iters):
        state = renderer.step(state, camera)
    jax.block_until_ready(state.accum)
    dt = (time.time() - t0) / iters

    # Each step converges frames_per_step (=spp) progressive frames, so the
    # headline number is spp-batched frames (pixel samples) per second.
    fps = w["spp"] / dt
    log(f"steady state: {dt * 1000:.1f} ms/step ({w['spp']} spp/step), "
        f"{fps:.3f} frames/s")

    out_png = os.environ.get("OGLRT_BENCH_PNG")
    if out_png:
        from opengl_raytracer_tpu.utils.image import save_png
        save_png(out_png, renderer.image(state))
        log(f"wrote {out_png}")

    print(json.dumps({
        "metric": _metric_name(w),
        "value": fps,
        "unit": "fps",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))


def supervise() -> int:
    """Parent: run the measurement in a child with a time limit; relay its
    JSON line, or return non-zero when it failed."""
    timeout = float(os.environ.get("OGLRT_BENCH_TIMEOUT", 1500))
    env = dict(os.environ, OGLRT_BENCH_CHILD="1")
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__)],
            env=env, stdout=subprocess.PIPE, timeout=timeout,
            cwd=os.path.dirname(os.path.abspath(__file__)) or None,
        )
    except subprocess.TimeoutExpired:
        log(f"bench: timed out after {timeout:.0f}s")
        return 1
    lines = [ln for ln in proc.stdout.decode().splitlines() if ln.strip()]
    if proc.returncode != 0 or not lines:
        log(f"bench: child failed (rc={proc.returncode})")
        return proc.returncode or 1
    try:
        json.loads(lines[-1])
    except json.JSONDecodeError:
        log(f"bench: unparseable output {lines[-1]!r}")
        return 1
    print(lines[-1])
    return 0


def main() -> int:
    if os.environ.get("OGLRT_BENCH_CHILD"):
        run_bench()
        return 0
    return supervise()


if __name__ == "__main__":
    raise SystemExit(main())
