"""Demo driver — the reference's `main.cpp` as a runtime-configurable CLI.

`python -m jax_bvh.app --builder two_pass --scene cornellbox` loads a scene,
builds (with per-phase timing like the reference's perf block,
`TwoPassLbvh.cpp:300-310`), validates, reports SAH costs, renders primary
rays to `test.png` and optionally a leaf-visit heat map to `colorMap.png`
(`main.cpp:26-86` behavior, with the builder chosen at runtime instead of
by `#define`, `main.cpp:18-22`).
"""
from __future__ import annotations

import sys

import numpy as np

from .config import EngineConfig, parse_args


def _load_scene(cfg: EngineConfig):
    from .utils import scenes

    if cfg.scene.endswith(".obj"):
        from .utils.obj import load_obj

        tris = load_obj(cfg.scene)
        preset = "cornellbox"
    elif cfg.scene == "cornellbox":
        tris = scenes.cornellbox()
        preset = "cornellbox"
    elif cfg.scene == "bunny_like":
        tris = scenes.bunny_like()
        preset = "bunny"
    elif cfg.scene == "sponza_like":
        tris = scenes.sponza_like()
        preset = "sponza"
    else:
        raise ValueError(f"unknown scene {cfg.scene!r}")
    tr, cam = scenes.preset(preset)
    return tris, tr, cam


def run(cfg: EngineConfig) -> dict:
    import jax
    import jax.numpy as jnp

    from .models import batched, binned_sah, ploc
    from .ops import collapse as collapse_ops
    from .ops import aabb as A
    from .ops import extents as extents_ops
    from .ops import morton as morton_ops
    from .ops import radix_tree, refit, sort, traverse
    from .ops import ploc as ploc_ops
    from .types import Bvh2, PrimRefs
    from .utils import camera, image, split_clip, validate
    from .utils.cost import sah_cost_bvh2, sah_cost_bvh4
    from .utils.timer import Timer, TimerCodes

    tris_np, tr, cam = _load_scene(cfg)
    n = tris_np.shape[0]
    print(f"scene: {cfg.scene} ({n} tris), builder: {cfg.builder}")
    tris = jnp.asarray(tris_np)
    timer = Timer()
    results: dict = {}

    if cfg.builder == "batched":
        # the reference's batched demo: 4096 copies of the scene, one BVH
        # per mesh (`main.cpp:39-47`)
        n_copies = 4096
        assert n <= 32, "batched demo requires meshes of <= 32 prims"
        tris_b, _ = batched.pad_meshes([tris_np] * n_copies)
        with timer.span(TimerCodes.BVH_BUILD):
            bvhs = jax.block_until_ready(batched.build_batched(jnp.asarray(tris_b)))
        one = type(bvhs)(*[np.asarray(f)[0] for f in bvhs])
        assert validate.check_bvh2_correctness(one, tris_b.shape[1])
        print(f"built {n_copies} BVHs")
        print(timer.report())
        results["total_ms"] = timer.total_ms
        return results

    if cfg.builder == "binned_sah":
        with timer.span(TimerCodes.BVH_BUILD):
            sah = binned_sah.build_binned_sah(tris_np)
        bvh = binned_sah.to_bvh2(sah)
        print(f"Binned Sah Cost : {binned_sah.sah_cost(sah):.4f}")
    else:
        # staged pipeline for per-phase timing (the fused single-jit builds
        # in models/ are what bench.py times)
        mn, mx, pidx = split_clip.early_split_clipping(
            tris_np, cfg.split_clip_sa_max
        )
        refs = PrimRefs(
            aabb_min=jnp.asarray(mn),
            aabb_max=jnp.asarray(mx),
            prim_idx=jnp.asarray(pidx),
        )
        ext_fn = jax.jit(lambda a, b: extents_ops.scene_extents(a, b))
        scene_min, scene_max = timer.measure(
            TimerCodes.CALCULATE_CENTROID_EXTENTS, ext_fn, refs.aabb_min, refs.aabb_max
        )

        def _codes(refs, smin, smax):
            ctr = A.center(refs.aabb_min, refs.aabb_max)
            norm = morton_ops.normalize_centroids(ctr, smin, smax - smin)
            if cfg.use_extended_morton:
                return morton_ops.extended_morton30(norm, smax - smin)
            return morton_ops.morton30(norm)

        codes = timer.measure(
            TimerCodes.CALCULATE_MORTON_CODES, jax.jit(_codes), refs, scene_min, scene_max
        )
        order = jnp.arange(codes.shape[0], dtype=jnp.int32)
        sorted_codes, sorted_pos = timer.measure(
            TimerCodes.SORTING, jax.jit(sort.sort_pairs), codes, order
        )

        def _topology(codes, refs, sorted_pos):
            leaf_min = refs.aabb_min[sorted_pos]
            leaf_max = refs.aabb_max[sorted_pos]
            leaf_prim = refs.prim_idx[sorted_pos]
            if cfg.builder == "two_pass":
                left, right, _p, first, last = radix_tree.karras_topology(codes)
                imin, imax = refit.refit_ranges(leaf_min, leaf_max, first, last)
                root = jnp.zeros((), jnp.int32)
            elif cfg.builder == "single_pass":
                left, right, _p, first, last, root = radix_tree.apetrei_topology(codes)
                imin, imax = refit.refit_ranges(leaf_min, leaf_max, first, last)
            else:  # ploc / hploc
                l2, r2, imin, imax = ploc_ops.ploc_build_topology(
                    leaf_min, leaf_max, codes, hploc=cfg.builder == "hploc"
                )
                nl = leaf_min.shape[0]
                left = jnp.concatenate([l2, jnp.zeros((nl,), jnp.int32)])
                right = jnp.concatenate([r2, jnp.full((nl,), -1, jnp.int32)])
                root = jnp.zeros((), jnp.int32)
            nl = leaf_min.shape[0]
            left = left.at[nl - 1 :].set(leaf_prim)
            node_min = jnp.concatenate([imin, leaf_min], axis=0)
            node_max = jnp.concatenate([imax, leaf_max], axis=0)
            return Bvh2.from_rows(node_min, node_max, left, right, root)

        bvh = timer.measure(
            TimerCodes.BVH_BUILD, jax.jit(_topology), sorted_codes, refs, sorted_pos
        )
        assert validate.check_bvh2_correctness(bvh, None)
        print(f"Bvh Cost : {float(sah_cost_bvh2(bvh)):.4f}")

        if cfg.collapse:
            wide = timer.measure(
                TimerCodes.COLLAPSE_BVH, collapse_ops.collapse_bvh2_to_bvh4, bvh
            )
            pmn, pmx = A.triangle_aabbs(tris)
            c4 = float(sah_cost_bvh4(wide, pmn, pmx))
            print(f"Bvh4 Cost : {c4:.4f}")
            results["sah_bvh4"] = c4

    rays = timer.measure(
        TimerCodes.RAY_GEN, jax.jit(lambda: camera.generate_rays(cam, cfg.width, cfg.height))
    )
    if cfg.traversal == "raster":
        from .ops import raster as raster_ops

        rpack = raster_ops.pack_raster(bvh, tris, leaf_size=16 if n < 4096 else 64)
        engine = raster_ops.raster_engine()
        print(f"raster engine: {engine}"
              + (" (plain reference: no GPU)" if engine == "xla" else ""))
        hit, counts, ovf = timer.measure(
            TimerCodes.TRAVERSAL, raster_ops.render_raster,
            rpack, rays, tr, cfg.width, cfg.height,
        )
        if bool(ovf):
            raise RuntimeError("raster candidate list overflowed; hits incomplete")
    else:
        hit, counts = timer.measure(
            TimerCodes.TRAVERSAL,
            lambda: traverse.traverse_bvh2(bvh, tris, rays, tr, variant=cfg.traversal),
        )
    img = image.shade_barycentric(
        np.asarray(hit.prim_idx), np.asarray(hit.u), np.asarray(hit.v), cfg.width, cfg.height
    )
    image.write_png(cfg.out_image, img)
    print(f"wrote {cfg.out_image}")
    if cfg.heatmap:
        image.write_png(cfg.out_heatmap, image.heatmap(counts, cfg.width, cfg.height))
        print(f"wrote {cfg.out_heatmap}")

    print(timer.report())
    results["total_ms"] = timer.total_ms
    return results


def main(argv=None) -> None:
    import sys

    if "--profile" in (argv or sys.argv[1:]):
        argv = [a for a in (argv or sys.argv[1:]) if a != "--profile"]
        from .utils.introspect import profiler_trace

        with profiler_trace("traces"):
            run(parse_args(argv))
        print("profiler trace written to traces/")
        return
    run(parse_args(argv))


if __name__ == "__main__":
    main()
