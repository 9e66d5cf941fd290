"""ctypes bindings to the native IO runtime (native/libtbvh_native.so).

The reference's host runtime is C++ (tinyobjloader for meshes, stb for PNG);
ours is too — `tbvh_load_obj` / `tbvh_write_png` — with pure-Python
fallbacks (`jax_bvh.utils.obj` / `jax_bvh.utils.image`) when the shared
library hasn't been built (`make -C native`).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(root, "native", "libtbvh_native.so")
    if not os.path.exists(path):
        src = os.path.join(root, "native", "tbvh_native.cpp")
        if os.path.exists(src):
            try:
                subprocess.run(
                    ["make", "-C", os.path.dirname(src)],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except Exception:  # noqa: BLE001
                return None
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.tbvh_load_obj.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.tbvh_load_obj.restype = ctypes.c_int
    lib.tbvh_free.argtypes = [ctypes.c_void_p]
    lib.tbvh_write_png.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.tbvh_write_png.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _lib() is not None


def load_obj(path: str) -> np.ndarray | None:
    """Native OBJ load -> f32[N,3,3], or None if the library is missing."""
    lib = _lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.tbvh_load_obj(path.encode(), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"tbvh_load_obj({path!r}) failed: rc={rc}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value, 3, 3)).copy()
    finally:
        lib.tbvh_free(out)
    return arr


def write_png(path: str, rgba: np.ndarray) -> bool:
    """Native PNG write; returns False if the library is missing."""
    lib = _lib()
    if lib is None:
        return False
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, c = rgba.shape
    assert c == 4
    rc = lib.tbvh_write_png(
        path.encode(),
        rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w,
        h,
    )
    if rc != 0:
        raise IOError(f"tbvh_write_png({path!r}) failed: rc={rc}")
    return True
