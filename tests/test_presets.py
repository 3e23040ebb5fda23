"""Preset scenes and baseline configs: construction, fallbacks, and the
default scene's object-level parity with the reference (main.py:19-111)."""

import numpy as np
import pytest

from opengl_raytracer_tpu.presets import (
    DEFAULT_CAM_DIR,
    DEFAULT_CAM_POS,
    baseline_configs,
    default_config,
    default_objects,
)


def test_default_scene_composition():
    objs = default_objects()
    # 2 Meshes + 7 Rects, reference order (main.py:101-111 runs 9 objects)
    assert len(objs) == 9
    # the light: emission 1.5, white emission color (main.py:91-99)
    light = objs[7]
    assert light.emission == 1.5
    np.testing.assert_allclose(np.asarray(light.emission_color), [1, 1, 1])
    # the mirror sphere: roughness 0 (main.py:28-35)
    assert objs[1].roughness == 0
    # default camera pose (main.py:151-152)
    assert DEFAULT_CAM_POS == (-33.7, 14.8, -21.1)
    assert DEFAULT_CAM_DIR == (65.0, -25.4)


def test_default_config_matches_reference_main():
    cfg = default_config()
    # main.py:447-454 constants
    assert cfg.bounces == 7 and cfg.n_bounces == 8
    assert cfg.rays_per_pixel == 1
    assert cfg.jitter_amount == 0.001
    assert cfg.lambertian is True
    assert cfg.sky_brightness == 1.0
    assert cfg.tile_size == 1


def test_baseline_configs_construct():
    """Configs 4 and 5 build from the generated default scene with no
    asset on disk; configs 1-3 need their OBJs and say so when missing."""
    built = set()
    for name, cfg in baseline_configs().items():
        assert cfg["config"].width > 0
        for key in ("objects", "fallback_objects"):
            if key not in cfg:
                continue
            try:
                objs = cfg[key]()
            except FileNotFoundError as e:
                assert "OGLRT_MODELS_PATH" in str(e)
                continue
            assert len(objs) >= 1
            built.add(name)
            break
    assert {"minidragon_1080p", "mediumdragon_1080p"} <= built


def test_negative_emission_rejected():
    """The integrator's 12-operand reorder sort relies on live rays carrying
    incoming == 0 (light is only added at the death event); a negative
    emission would violate that invariant, so Scene rejects it at build."""
    from opengl_raytracer_tpu.models.rect import Rect
    from opengl_raytracer_tpu.models.scene import Scene

    bad = Rect([1, 1, 0.1], [0, 0, 0], [0, 0, 0], [1, 1, 1], emission=-0.5)
    with pytest.raises(ValueError, match="negative emission"):
        Scene([bad])
