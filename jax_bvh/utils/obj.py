"""Minimal OBJ mesh loader (tinyobjloader-equivalent for this engine).

Replaces the reference's vendored tinyobjloader + `MeshLoader::loadScene`
(`src/Utility.cpp:614-760`), which parses an OBJ, dedups
vertices and emits a flat triangle soup (materials/normals dropped). Supports
v / f records with polygon fan triangulation and negative indices. A native
C++ fast path is planned for large scenes.
"""
from __future__ import annotations

import numpy as np


def load_obj(path: str, prefer_native: bool = True) -> np.ndarray:
    """Parse an OBJ file into a triangle soup f32[N, 3, 3].

    Uses the C++ loader (native/tbvh_native.cpp) when built; this function
    is the pure-Python reference implementation and fallback."""
    if prefer_native:
        from . import native

        tris = native.load_obj(path) if native.available() else None
        if tris is not None:
            return tris
    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                parts = line.split()[1:]
                idx = []
                for p in parts:
                    vi = p.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, dtype=np.float32)
    fidx = np.asarray(faces, dtype=np.int64)
    return v[fidx]  # [N, 3, 3]
