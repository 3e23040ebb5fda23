"""Render every BASELINE.json benchmark config and report timings.

Usage:  python examples/run_baselines.py [--frames N] [--outdir DIR]

Configs 4 and 5 run on the generated default scene; configs 1-3 need
their OBJs (supply them via OGLRT_MODELS_PATH) and are skipped without.
"""

import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E401,E702

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--outdir", default="baselines_out")
    ap.add_argument("--only", default=None, help="run a single config by name")
    args = ap.parse_args()

    import jax

    from opengl_raytracer_tpu.models.scene import Scene
    from opengl_raytracer_tpu.ops.camera import make_camera
    from opengl_raytracer_tpu.presets import baseline_configs
    from opengl_raytracer_tpu.renderer import Renderer
    from opengl_raytracer_tpu.utils.image import save_png

    os.makedirs(args.outdir, exist_ok=True)
    report = {}
    for name, cfg in baseline_configs().items():
        if args.only and name != args.only:
            continue
        try:
            objects = cfg["objects"]()
            used_fallback = False
        except FileNotFoundError:
            try:
                objects = cfg["fallback_objects"]()
            except (KeyError, FileNotFoundError):
                print(f"[{name}] SKIP (asset missing, no usable fallback)")
                continue
            used_fallback = True

        scene = Scene(objects)
        r = Renderer(scene, cfg["config"])
        cam = make_camera(cfg["cam_pos"], cfg["cam_dir"])

        t0 = time.time()
        state = r.render(camera=cam, frames=1)
        jax.block_until_ready(state.accum)
        first = time.time() - t0

        if args.frames > 1:
            t0 = time.time()
            state = r.render(camera=cam, frames=args.frames - 1, state=state)
            jax.block_until_ready(state.accum)
            steady = (time.time() - t0) / (args.frames - 1)
        else:
            steady = first  # no steady-state sample; report the first frame

        out = os.path.join(args.outdir, f"{name}.png")
        save_png(out, r.image(state))
        report[name] = {
            "tris": scene.total_triangles,
            "resolution": f"{cfg['config'].width}x{cfg['config'].height}",
            "bounces": cfg["config"].bounces,
            "first_frame_s": round(first, 2),
            "ms_per_frame": round(steady * 1000, 1),
            "fps": round(1.0 / steady, 3) if steady > 0 else None,
            "fallback_assets": used_fallback,
            "png": out,
        }
        print(f"[{name}] {report[name]}")

    with open(os.path.join(args.outdir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"\nWrote {args.outdir}/report.json")


if __name__ == "__main__":
    main()
