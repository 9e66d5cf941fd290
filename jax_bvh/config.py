"""Runtime configuration.

The reference selects everything at compile time: builder `#define`s
(`main.cpp:18-22`), traversal-variant toggles (`TwoPassLbvh.cpp:12-15`),
`__SHARED_STACK`, hard-coded scene poses. Here the same axes are a runtime
dataclass + CLI (SURVEY.md §5 "Config / flag system").
"""
from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

BUILDERS = ("two_pass", "single_pass", "ploc", "hploc", "binned_sah", "batched")
TRAVERSAL_VARIANTS = (
    "if_if", "while_while", "speculative", "restart_trail", "raster"
)
SCENES = ("cornellbox", "bunny_like", "sponza_like")


@dataclass
class EngineConfig:
    builder: str = "two_pass"
    traversal: str = "speculative"  # the reference default (WHILEWHILE branch
    # launches BvhTraversalSpeculativeWhile, TwoPassLbvh.cpp:277-295)
    scene: str = "cornellbox"
    width: int = 512
    height: int = 512
    use_extended_morton: bool = True  # both LBVH paths use extended codes
    # (CommonBlocksKernel.h:383,396)
    split_clip_sa_max: float = float("inf")  # USE_PRIM_SPLITTING default off
    collapse: bool = True  # USE_GPU_WIDE_COLLAPSE
    heatmap: bool = False
    out_image: str = "test.png"
    out_heatmap: str = "colorMap.png"

    def validate(self) -> "EngineConfig":
        assert self.builder in BUILDERS, self.builder
        assert self.traversal in TRAVERSAL_VARIANTS, self.traversal
        return self


def parse_args(argv=None) -> EngineConfig:
    p = argparse.ArgumentParser(description="jax_bvh demo driver")
    p.add_argument("--builder", choices=BUILDERS, default="two_pass")
    p.add_argument("--traversal", choices=TRAVERSAL_VARIANTS, default="speculative")
    p.add_argument("--scene", default="cornellbox", help="preset name or path to .obj")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--plain-morton", action="store_true")
    p.add_argument("--split-clip", type=float, default=float("inf"), metavar="SA_MAX")
    p.add_argument("--no-collapse", action="store_true")
    p.add_argument("--heatmap", action="store_true")
    p.add_argument("--out", default="test.png")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    a = p.parse_args(argv)
    if a.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    return EngineConfig(
        builder=a.builder,
        traversal=a.traversal,
        scene=a.scene,
        width=a.width,
        height=a.height,
        use_extended_morton=not a.plain_morton,
        split_clip_sa_max=a.split_clip,
        collapse=not a.no_collapse,
        heatmap=a.heatmap,
        out_image=a.out,
    ).validate()


def use_compile_cache(min_compile_secs: float = 0.5) -> None:
    """Keep JAX's persistent compile cache where `JAX_COMPILATION_CACHE_DIR`
    says (JAX reads that variable itself), else in `.jax_cache/` at the
    root of this checkout — a fixed path, so that later runs from this
    checkout find what earlier ones compiled."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
