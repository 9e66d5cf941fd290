"""PNG output + shading/heat-map color mapping.

Replaces stb_image_write (`src/Utility.cpp:452`,
`TwoPassLbvh.cpp:298`) with a dependency-free zlib PNG encoder, and ports the
reference's color mappings: barycentric RGBA shading
(`TraversalKernel.h:444-450`) and the green/blue leaf-visit heat map
(`Utility.cpp:424-454`).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgba: np.ndarray, prefer_native: bool = True) -> None:
    """rgba: u8[H, W, 4]. Uses the C++ writer (native/tbvh_native.cpp) when
    built; the code below is the pure-Python fallback."""
    h, w, c = rgba.shape
    assert c == 4 and rgba.dtype == np.uint8
    if prefer_native:
        from . import native

        if native.available() and native.write_png(path, rgba):
            return

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + rgba[r].tobytes() for r in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
    out += chunk(b"IDAT", zlib.compress(raw, 6))
    out += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def shade_barycentric(hit_prim, hit_u, hit_v, width: int, height: int) -> np.ndarray:
    """RGBA = (u, v, 1-u-v) * 255 on hit, else 0 — the output of every GPU
    traversal kernel (`TraversalKernel.h:444-450`). Flat ray index is
    x * height + y (`GenerateRays`), so reshape to [W, H] then transpose is
    NOT applied — the reference writes the buffer with the same indexing it
    renders, producing its characteristic orientation; we keep it.
    """
    u = np.asarray(hit_u)
    v = np.asarray(hit_v)
    prim = np.asarray(hit_prim)
    hit = prim >= 0
    img = np.zeros((width * height, 4), np.uint8)
    w = 1.0 - u - v
    img[hit, 0] = np.clip(u[hit] * 255, 0, 255).astype(np.uint8)
    img[hit, 1] = np.clip(v[hit] * 255, 0, 255).astype(np.uint8)
    img[hit, 2] = np.clip(w[hit] * 255, 0, 255).astype(np.uint8)
    img[hit, 3] = 255
    return img.reshape(width, height, 4)


def heatmap(counts, width: int, height: int) -> np.ndarray:
    """`generateTraversalHeatMap` (`Utility.cpp:424-454`): leaf-visit counts
    normalized by the max, mapped to (150, 255, 255)-scaled green/blue."""
    c = np.asarray(counts).astype(np.float64)
    m = c.max() if c.max() > 0 else 1.0
    norm = c / m
    img = np.zeros((width * height, 4), np.uint8)
    img[:, 0] = np.clip(norm * 150, 0, 255).astype(np.uint8)
    img[:, 1] = np.clip(norm * 255, 0, 255).astype(np.uint8)
    img[:, 2] = 255
    img[:, 3] = 255
    return img.reshape(width, height, 4)
