"""On-card smoke test: the path tracer's main path, once, at its real size.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py                  # phases 1-4 on one card
    python chip_smoke.py --trace DIR      # also profile one 1080p step
    python chip_smoke.py --multi          # phase 5 only, on four cards

Phases (any failure exits non-zero; there is no CPU fallback):

1. Device: JAX must find a GPU.  Prints the card's name and power limit,
   ``device_kind`` and the device count.
2. Real-size render: the generated default scene (presets.default_objects,
   27,542 triangles) at 1920x1080, 4 bounces, 1 spp, through ``Renderer``
   with ``traversal="auto"``, which must resolve to ``packet``.  Prints the
   scene build and upload times, first-step compile+run seconds, steady
   ms/frame over 8 frames, peak device bytes and the frame's mean and max.
3. Traversal agreement: ``raycast_packet`` against the brute-force
   reference ``raycast_brute`` on 256K primary rays of that frame and on
   their first-bounce rays.  Hit/miss and triangle id must agree on
   >= 99.99% of rays.  Not exact: the two pick their triangle with
   different float expressions, so a ray grazing a shared edge may pick
   either neighbour.  Where the ids agree, |dt|/t <= 1e-5 between the
   two; both report t in the shader's per-ray expression, so this reads 0
   unless one of them stops doing so.  Each one's t is therefore also
   held to a float64 evaluation on the host of the same ray against the
   triangle it picked: |dt| <= 1e-6 c, where c = |v0 - o| |n| / |d . n|
   (>= t) is the size of the terms t is computed from, about 8 float32
   roundings of them.
4. Image parity: (a) the small closed box of tests/test_render.py at
   64x48, 3 bounces, 2 frames, against the scalar oracle (tests/oracle.py),
   RMSE <= 1e-4; (b) the 1080p ``packet`` frame against the per-ray
   ``bvh`` walk, RMSE <= 1e-5.
5. ``--multi``: ``ShardedRenderer`` on meshes (dp, sp) = (4, 1) and (2, 2)
   over the 1080p scene against the single-device ``Renderer`` at the same
   frame count, RMSE <= 1e-6 (the per-pixel samples are identical; only
   the order of the psum can differ).  Prints the first step's seconds
   (with compilation) and the ms of each later step (one or two: too few
   for a steady rate).

Everything runs in this one process, which holds the card(s).  The last
line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
W, H, BOUNCES = 1920, 1080, 4
GRID = 512  # phase 3 samples a GRID x GRID pixel grid of the frame


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(jax):
    """Phase 1: a GPU, its name and power limit."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"JAX found no GPU (platform {devs[0].platform!r}, "
             f"{devs[0].device_kind}); this check runs only on the card")
    from opengl_raytracer_tpu.utils.profiling import gpu_name_and_power_limit

    log(gpu_name_and_power_limit())
    log(f"device_kind: {devs[0].device_kind}")
    log(f"device_count: {len(devs)}")
    return devs


def build_scene():
    from opengl_raytracer_tpu import Scene
    from opengl_raytracer_tpu.presets import default_objects

    t0 = time.perf_counter()
    scene = Scene(default_objects())
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    import jax

    data = jax.block_until_ready(scene.send())
    t_send = time.perf_counter() - t0
    nbytes = sum(x.nbytes for x in jax.tree_util.tree_leaves(data))
    log(f"scene: {scene.total_triangles} triangles, {scene.total_boxes} BVH "
        f"nodes; host build {t_build:.3f} s, send+upload {t_send:.3f} s, "
        f"{nbytes} device bytes")
    return scene


def default_camera():
    from opengl_raytracer_tpu.ops.camera import make_camera
    from opengl_raytracer_tpu.presets import DEFAULT_CAM_DIR, DEFAULT_CAM_POS

    return make_camera(DEFAULT_CAM_POS, DEFAULT_CAM_DIR)


def phase_render(jax, dev, scene, camera, trace_dir):
    """Phase 2: 1080p / 4 bounces / 1 spp through Renderer."""
    from opengl_raytracer_tpu import Renderer, RenderConfig
    from opengl_raytracer_tpu.utils.config import SKY_COLOR

    cfg = RenderConfig(width=W, height=H, bounces=BOUNCES, rays_per_pixel=1,
                       tile_size=1, traversal="auto")
    r = Renderer(scene, cfg)
    check(r.traversal == "packet", f"auto resolved to {r.traversal!r}")

    state = r.init_state()
    t0 = time.perf_counter()
    state = r.step(state, camera)
    jax.block_until_ready(state.accum)
    log(f"render: first step (compile+run) {time.perf_counter() - t0:.2f} s")
    times = []
    for _ in range(8):
        t0 = time.perf_counter()
        state = r.step(state, camera)
        jax.block_until_ready(state.accum)
        times.append(time.perf_counter() - t0)
    ms = np.asarray(times) * 1e3
    log(f"render: {len(ms)} steady frames, median {np.median(ms):.2f} "
        f"ms/frame (min {ms.min():.2f}, max {ms.max():.2f})")
    stats = dev.memory_stats() or {}
    log(f"render: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")

    img = r.image(state)
    check(img.shape == (H, W, 3), f"image shape {img.shape}")
    check(np.isfinite(img).all(), "image has non-finite values")
    log(f"render: frame {state.frame_count}, mean {img.mean():.6f}, "
        f"max {img.max():.6f}")
    sky = np.abs(img - np.asarray(SKY_COLOR, np.float32)).max(axis=-1) < 1e-3
    check(sky.mean() < 0.5, f"{sky.mean():.1%} of pixels are sky")
    check(img.mean() > 0.01, f"image is black (mean {img.mean()})")
    for mod in ("PIL", "pygame"):
        check(mod not in sys.modules, f"the headless path imported {mod}")

    if trace_dir:
        trace_step(jax, r, state, camera, trace_dir)
    return r


def trace_step(jax, r, state, camera, trace_dir):
    """Profile one more 1080p step and print the device operations that
    took the most time (summed per operation name)."""
    import glob

    from opengl_raytracer_tpu.utils.profiling import trace

    with trace(trace_dir):
        state = r.step(state, camera)
        jax.block_until_ready(state.accum)
    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    totals, busy = {}, []
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = list(plane.lines)
        log(f"trace: plane {plane.name} lines {[ln.name for ln in lines]}")
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines if ln.name.startswith("Stream")]
        for line in ops:
            for ev in line.events:
                n, c = totals.get(ev.name, (0.0, 0))
                totals[ev.name] = (n + ev.duration_ns, c + 1)
                busy.append((ev.start_ns, ev.end_ns))
    check(totals, "the trace holds no device operations")
    busy.sort()
    covered, end = 0.0, -1.0
    for s, e in busy:
        if e > end:
            covered += e - max(s, end)
            end = e
    window = max(e for _, e in busy) - busy[0][0]
    log(f"trace: device busy {covered / 1e6:.2f} ms of a "
        f"{window / 1e6:.2f} ms window")
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ns, count) in top:
        log(f"trace: {ns / 1e6:10.3f} ms  x{count:<5d} {name[:100]}")


def sample_pixels():
    """GRID x GRID pixels spread over the frame (256K at 1080p), ordered
    in 8x16 blocks (the renderer's coherent packet order)."""
    gx = (np.arange(GRID) * W) // GRID
    gy = (np.arange(GRID) * H) // GRID
    px, py = np.meshgrid(gx, gy)
    blocks = lambda a: (a.reshape(GRID // 8, 8, GRID // 16, 16)
                        .transpose(0, 2, 1, 3).ravel())
    return blocks(px).astype(np.int32), blocks(py).astype(np.int32)


def t_error(scene, o, d, near, act):
    """Float32 error of each active hit's t against a float64 evaluation,
    on the host, of the same ray and the triangle it hit.

    Returns the largest |t - t64| / t64 and the largest |t - t64| / c,
    where c = |v0 - o| |n| / |d . n| >= t64 is the size of the terms t is
    computed from: a bounce ray that hits a neighbouring triangle at
    t << |v0 - o| loses digits of t to float32 rounding of those terms,
    whichever traversal found the hit."""
    tri = np.asarray(near.tri)
    t = np.asarray(near.t).astype(np.float64)
    hit = act & (t < 1e29)
    v0 = np.asarray(scene.v0, np.float64)[tri[hit]]
    face = np.asarray(scene.face, np.float64)[tri[hit]]
    vro = v0 - np.asarray(o, np.float64)[hit]
    dn = (np.asarray(d, np.float64)[hit] * face).sum(-1)
    t64 = (vro * face).sum(-1) / dn
    c = np.linalg.norm(vro, axis=-1) * np.linalg.norm(face, axis=-1) / np.abs(dn)
    err = np.abs(t[hit] - t64)
    if not err.size:
        return 0.0, 0.0
    return float((err / t64).max()), float((err / c).max())


def agreement(label, scene, o, d, near_b, near_p, active):
    t_b, t_p = np.asarray(near_b.t), np.asarray(near_p.t)
    tri_b, tri_p = np.asarray(near_b.tri), np.asarray(near_p.tri)
    act = np.asarray(active)
    big = 1e29
    hit_b, hit_p = t_b < big, t_p < big
    same = (hit_b == hit_p) & (~hit_b | (tri_b == tri_p))
    n = int(act.sum())
    frac = float(same[act].mean())
    both = act & hit_b & hit_p & (tri_b == tri_p)
    rel = np.abs(t_b[both] - t_p[both]) / np.maximum(t_b[both], 1e-30)
    worst = float(rel.max()) if rel.size else 0.0
    log(f"agreement {label}: {n} rays, {hit_b[act].mean():.4%} hit, "
        f"packet==brute on {frac:.6%} ({int((~same & act).sum())} differ), "
        f"max |dt|/t between them {worst:.3e}")
    check(n >= GRID * GRID // 2, f"{label}: only {n} rays")
    check(frac >= 0.9999, f"{label}: agreement {frac:.6%} < 99.99%")
    check(worst <= 1e-5, f"{label}: |dt|/t {worst:.3e} > 1e-5")
    for name, near in (("brute", near_b), ("packet", near_p)):
        rel64, scaled = t_error(scene, o, d, near, act)
        log(f"agreement {label}: {name} t against float64: max |dt|/t "
            f"{rel64:.3e}, max |dt|/c {scaled:.3e}")
        check(scaled <= 1e-6, f"{label}: {name} |dt|/c {scaled:.3e} > 1e-6")


def phase_agreement(jax, r, camera):
    """Phase 3: packet vs brute force on primary and first-bounce rays."""
    import jax.numpy as jnp

    from opengl_raytracer_tpu.ops import rng
    from opengl_raytracer_tpu.ops.camera import pixel_uv, ray_dirs_soa
    from opengl_raytracer_tpu.ops.integrator import scatter
    from opengl_raytracer_tpu.ops.intersect import finalize_hit, raycast_brute
    from opengl_raytracer_tpu.ops.traversal import raycast_packet

    scene = r.scene
    px, py = sample_pixels()
    u, v = pixel_uv(jnp.asarray(px), jnp.asarray(py), W, H)
    d = jnp.stack(ray_dirs_soa(camera, u, v, W, H), axis=-1)
    o = jnp.broadcast_to(camera.pos, d.shape)

    brute = jax.jit(raycast_brute)
    packet = jax.jit(lambda s, o, d, a: raycast_packet(
        s, o, d, a, max_leaf_tris=r.config.max_leaf_tris))
    everyone = jnp.ones(d.shape[0], bool)
    near_b = brute(scene, o, d, everyone)
    near_p = packet(scene, o, d, everyone)
    agreement("primary", scene, o, d, near_b, near_p, everyone)

    # First-bounce rays from the reference's primary hits.
    hit = finalize_hit(scene, o, d, near_b)
    seed = rng.warmup(rng.seed_pixels(jnp.asarray(px), jnp.asarray(py), 0), 5)
    _, d1 = scatter(seed, hit.normal, d, hit.roughness, True)
    o1 = hit.point + hit.normal * np.float32(1e-4)
    active = hit.did_hit & ~(hit.emission > 0)
    agreement("first-bounce", scene, o1, d1, brute(scene, o1, d1, active),
              packet(scene, o1, d1, active), active)


def phase_parity(r, camera):
    """Phase 4: oracle parity on a small box, packet vs bvh at 1080p."""
    sys.path.insert(0, os.path.join(_ROOT, "tests"))
    from test_render import cornellish_objects, run_jax, run_oracle

    from opengl_raytracer_tpu import Renderer, RenderConfig
    from opengl_raytracer_tpu.utils.image import rmse

    for traversal in ("auto", "packet"):
        img, scene, cfg = run_jax(cornellish_objects(), w=64, h=48, bounces=3,
                                  frames=2, traversal=traversal)
        err = rmse(img, run_oracle(scene, cfg, frames=2))
        log(f"parity: 64x48 box ({traversal}) vs oracle, rmse {err:.3e}")
        check(err <= 1e-4, f"box {traversal} vs oracle rmse {err:.3e} > 1e-4")

    img_p = r.image(r.render(camera=camera, frames=1))
    rb = Renderer(r.scene, RenderConfig(width=W, height=H, bounces=BOUNCES,
                                        traversal="bvh"))
    t0 = time.perf_counter()
    img_b = rb.image(rb.render(camera=camera, frames=1))
    err = rmse(img_p, img_b)
    log(f"parity: 1080p packet vs bvh, rmse {err:.3e} "
        f"(bvh frame incl. compile {time.perf_counter() - t0:.1f} s)")
    check(err <= 1e-5, f"1080p packet vs bvh rmse {err:.3e} > 1e-5")


def phase_multi(jax, scene, camera):
    """Phase 5: ShardedRenderer on four cards against one card."""
    from opengl_raytracer_tpu import Renderer, RenderConfig
    from opengl_raytracer_tpu.parallel.sharding import ShardedRenderer, make_mesh
    from opengl_raytracer_tpu.utils.image import rmse

    check(len(jax.devices()) >= 4, f"--multi needs 4 GPUs, "
          f"found {len(jax.devices())}")
    cfg = RenderConfig(width=W, height=H, bounces=BOUNCES)
    frames = 2
    ref = Renderer(scene, cfg)
    ref_img = ref.image(ref.render(camera=camera, frames=frames))
    for dp, sp in ((4, 1), (2, 2)):
        sr = ShardedRenderer(scene, cfg, make_mesh(4, dp=dp, sp=sp))
        check(sr.traversal == "packet", f"sharded traversal {sr.traversal}")
        state, ms = sr.init_state(), []
        for _ in range(frames // sp + 1):  # the first step compiles
            if state.frame_count == frames:
                state = sr.init_state()
            t0 = time.perf_counter()
            state = sr.step(state, camera)
            jax.block_until_ready(state.accum)
            ms.append((time.perf_counter() - t0) * 1e3)
            if state.frame_count == frames:
                img = sr.image(state)
        err = rmse(img, ref_img)
        after = ", ".join(f"{x:.2f}" for x in ms[1:])
        log(f"multi: mesh (dp={dp}, sp={sp}) first step {ms[0] / 1e3:.2f} s "
            f"incl. compile; next {len(ms) - 1} step(s) {after} ms ({sp} "
            f"frame(s) per step); rmse vs one card after {frames} frames "
            f"{err:.3e}")
        check(err <= 1e-6, f"mesh ({dp},{sp}) rmse {err:.3e} > 1e-6")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only phase 5 (ShardedRenderer on four cards)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="profile one 1080p step into DIR and print the "
                        "top device operations")
    args = p.parse_args(argv)

    import jax

    devs = phase_device(jax)
    scene = build_scene()
    camera = default_camera()
    if args.multi:
        phase_multi(jax, scene, camera)
    else:
        r = phase_render(jax, devs[0], scene, camera, args.trace)
        phase_agreement(jax, r, camera)
        phase_parity(r, camera)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
