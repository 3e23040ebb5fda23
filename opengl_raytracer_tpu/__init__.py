"""Progressive Monte-Carlo path tracer in JAX.

A from-scratch rebuild of the capabilities of ``pirosow/openGL_raytracer``
(reference layout documented in SURVEY.md): OBJ loading, a Mesh/Rect/Scene
scene-graph with CPU world-space baking, median-split BVH acceleration, and a
per-pixel path-tracing kernel (angle-linear camera, Möller–Trumbore triangle
tests, slab AABB tests, diffuse/specular scatter, emissive lights, constant
sky, progressive accumulation, tile scheduling) — redesigned as jit-compiled
vectorized kernels over flat ray arrays instead of divergent per-fragment
shader programs.

Public API mirrors the reference's surface (reference: main.py:16,
object.py:8, object.py:241, scene.py:9) while the execution model is pure
functional JAX.
"""

import os as _os

# One fixed directory inside the checkout: the cache's path is part of its
# key, so a path that moved between processes would never hit.
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache, so a 1080p step compiles once per
    checkout.  ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own
    setting and wins; otherwise the cache lives in COMPILE_CACHE_DIR.
    Off with OGLRT_NO_COMPILE_CACHE=1."""
    if _os.environ.get("OGLRT_NO_COMPILE_CACHE"):
        return
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    # Cache everything that takes noticeable compile time.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compile_cache()

from opengl_raytracer_tpu.utils.config import RenderConfig
from opengl_raytracer_tpu.models.mesh import Mesh
from opengl_raytracer_tpu.models.rect import Rect
from opengl_raytracer_tpu.models.scene import Scene
from opengl_raytracer_tpu.ops.camera import Camera, camera_basis
from opengl_raytracer_tpu.renderer import Renderer, RenderState

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Mesh",
    "Rect",
    "Scene",
    "Camera",
    "camera_basis",
    "Renderer",
    "RenderState",
]
