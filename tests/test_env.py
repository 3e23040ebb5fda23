"""What the program needs from its environment: PNG output on the standard
library alone, the compile-cache location, a portable native build, and
the on-card scripts refusing to run without a GPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from opengl_raytracer_tpu.utils.image import load_png, save_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(1, 1), (17, 23), (48, 64)])
def test_png_round_trip(tmp_path, shape):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    save_png(path, img)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    back = load_png(path)
    assert back.dtype == np.float32 and back.shape == img.shape
    np.testing.assert_array_equal(np.round(back * 255).astype(np.uint8), img)


def test_png_float_clamps_and_rejects(tmp_path):
    path = str(tmp_path / "f.png")
    save_png(path, np.array([[[-1.0, 0.5, 2.0]]], np.float32))
    np.testing.assert_allclose(load_png(path)[0, 0], [0, 128 / 255, 1])
    with pytest.raises(ValueError):
        save_png(path, np.zeros((2, 2), np.uint8))
    (tmp_path / "bad.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        load_png(str(tmp_path / "bad.png"))


def run_py(code, env_update, cwd=ROOT, args=()):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "OGLRT_NO_COMPILE_CACHE")}
    env.update(JAX_PLATFORMS="cpu", **env_update)
    cmd = [sys.executable] + (["-c", code] if code else []) + list(args)
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)


@pytest.mark.parametrize("preset", [None, "custom"])
def test_compile_cache_dir(tmp_path, preset):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache is one fixed directory inside the checkout."""
    env = {"PYTHONPATH": ROOT}
    if preset:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / preset)
    code = ("import jax, opengl_raytracer_tpu as o; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(o.COMPILE_CACHE_DIR)")
    out = run_py(code, env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    got, fixed = out.stdout.split()
    assert fixed == os.path.join(ROOT, ".jax_cache")
    assert got == (str(tmp_path / preset) if preset else fixed)


def test_native_library_keyed_by_sources_and_host(tmp_path):
    from opengl_raytracer_tpu.native import loader

    srcs = [tmp_path / "a.cpp", tmp_path / "b.cpp"]
    for p in srcs:
        p.write_text("int f() { return 1; }\n")
    first = loader.lib_path([str(p) for p in srcs])
    assert first == loader.lib_path([str(p) for p in srcs])
    srcs[1].write_text("int f() { return 2; }\n")
    assert loader.lib_path([str(p) for p in srcs]) != first
    assert os.path.basename(first).startswith("_liboglrt-")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_card_scripts_refuse_cpu(script):
    """No CPU fallback: without a GPU both scripts exit non-zero and print
    no result line."""
    out = run_py(None, {"OGLRT_BENCH_TIMEOUT": "200"},
                 args=[os.path.join(ROOT, script)])
    assert out.returncode != 0
    assert "GPU" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
