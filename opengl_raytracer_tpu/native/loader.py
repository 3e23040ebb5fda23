"""Loader for the native (C++) runtime components.

The reference's native code is two Cython modules compiled at import time by
pyximport (scene.py:1, object.py:1): the OBJ parser (loadObject.pyx) and the
BVH builder (boundingBoxes.pyx).  Our equivalents live in ``objparser.cpp``
and ``bvh.cpp``, compiled on demand with g++ into one shared library and
bound via ctypes (no pybind11 in this image).  Every native entry point has
a pure-Python twin, so the framework degrades gracefully when no compiler
is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["objparser.cpp", "bvh.cpp"]
# Portable flags (no -march=native): a library built on one host must run
# on any host of the same machine type.
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path(srcs) -> str:
    """Library file keyed by the sources' contents, the compiler flags and
    the host's machine type, so a stale or foreign build is never
    loaded."""
    h = hashlib.sha256(" ".join(_FLAGS + [platform.machine()]).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_HERE, f"_liboglrt-{h.hexdigest()[:16]}.so")


def _build() -> str | None:
    """Path of the built library (building it if needed), or None."""
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    if not all(os.path.exists(s) for s in srcs):
        return None
    path = lib_path(srcs)
    if os.path.exists(path):
        return path
    # Build under a private name, then rename: concurrent processes never
    # load a half-written library.
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, *srcs, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    except (subprocess.SubprocessError, OSError):
        return None
    return path


def get_lib():
    """The loaded native library, building it if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None

        lib.obj_parse.restype = ctypes.c_longlong
        lib.obj_parse.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.c_int]  # progress
        lib.obj_free.restype = None
        lib.obj_free.argtypes = [ctypes.c_void_p]

        lib.bvh_build.restype = ctypes.c_longlong
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # v0
            ctypes.POINTER(ctypes.c_float),  # v1
            ctypes.POINTER(ctypes.c_float),  # v2
            ctypes.c_longlong,  # T
            ctypes.c_int,  # max_leaf_tris
            ctypes.c_int,  # method: 0 mean-split, 1 binned SAH
            ctypes.POINTER(ctypes.c_float),  # node_min (out, 2T x 3)
            ctypes.POINTER(ctypes.c_float),  # node_max
            ctypes.POINTER(ctypes.c_int),  # node_miss
            ctypes.POINTER(ctypes.c_int),  # node_first
            ctypes.POINTER(ctypes.c_int),  # node_count
            ctypes.POINTER(ctypes.c_longlong),  # perm (out, T)
            ctypes.POINTER(ctypes.c_int),  # depth (out, 1)
            ctypes.c_int,  # progress
        ]
        _lib = lib
        return _lib


def load_obj_native(file_path: str, progress: bool = False) -> np.ndarray:
    """Parse an OBJ via the C++ parser -> (N, 8) float32 (same layout as
    models/obj.py:load_obj_py).  progress prints the reference-style
    carriage-return percent bar from the C++ side (loadObject.pyx:20-21)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out_ptr = ctypes.c_void_p()
    n_floats = lib.obj_parse(file_path.encode(), ctypes.byref(out_ptr),
                             int(bool(progress)))
    if n_floats < 0:
        raise IOError(f"native OBJ parse failed for {file_path!r} ({n_floats})")
    try:
        buf = ctypes.cast(out_ptr, ctypes.POINTER(ctypes.c_float))
        arr = np.ctypeslib.as_array(buf, shape=(n_floats,)).copy()
    finally:
        lib.obj_free(out_ptr)
    return arr.reshape(-1, 8)


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     max_leaf_tris: int, method: int = 0,
                     progress: bool = False):
    """C++ BVH build -> same tuple layout as ops/bvh.py:build_bvh.
    method: 0 = reference mean-split, 1 = binned SAH.
    Returns None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    T = v0.shape[0]
    cap = 2 * T  # binary BVH with non-empty leaves has < 2T nodes
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_miss = np.empty(cap, np.int32)
    node_first = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    perm = np.empty(T, np.int64)
    depth = np.zeros(1, np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    c0 = np.ascontiguousarray(v0, np.float32)
    c1 = np.ascontiguousarray(v1, np.float32)
    c2 = np.ascontiguousarray(v2, np.float32)
    n = lib.bvh_build(
        fp(c0), fp(c1), fp(c2), T, max_leaf_tris, method,
        fp(node_min), fp(node_max), ip(node_miss), ip(node_first),
        ip(node_count),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        ip(depth), int(bool(progress)),
    )
    if n <= 0:
        raise RuntimeError(f"native BVH build failed ({n})")
    from opengl_raytracer_tpu.ops.bvh import BVH

    return BVH(
        node_min=node_min[:n].copy(),
        node_max=node_max[:n].copy(),
        node_miss=node_miss[:n].copy(),
        node_first=node_first[:n].copy(),
        node_count=node_count[:n].copy(),
        perm=perm,
        depth=int(depth[0]),
    )
