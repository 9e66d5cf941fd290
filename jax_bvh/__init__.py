"""jax_bvh — a BVH construction and traversal engine in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
Niravaana/HIP-BVH-Construction: LBVH (Karras
two-pass + Apetrei-equivalent single-pass), PLOC++/HPLOC agglomerative
builders, CPU binned-SAH reference, batched many-small-mesh builds sharded
over device meshes, BVH2->BVH4 collapse, four traversal strategies, SAH cost
oracles, OBJ scenes, rendering and heatmaps.
"""
from .types import (
    Bvh2,
    Bvh4,
    Camera,
    HitInfo,
    PrimRefs,
    Rays,
    Transformation,
)

__all__ = [
    "Bvh2",
    "Bvh4",
    "Camera",
    "HitInfo",
    "PrimRefs",
    "Rays",
    "Transformation",
]

__version__ = "0.1.0"
