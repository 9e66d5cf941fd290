"""Raster engine comparison on a GPU: the Triton kernel against the plain
XLA engine, each timed as the full render (binning included) on
sponza_like at 512^2 and 1920x1080, in one process on one card.

    PYTHONPATH=. python tools/raster_engines.py
"""
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("raster_engines: needs a GPU", file=sys.stderr)
        return 1
    from jax_bvh.config import use_compile_cache
    from jax_bvh.models import lbvh
    from jax_bvh.ops import raster, raster_triton
    from jax_bvh.utils import camera, scenes

    use_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    tris = jnp.asarray(scenes.sponza_like(262_000))
    tr, cam = scenes.preset("sponza")
    scene = raster.pack_raster(lbvh.build_single_pass(tris), tris, leaf_size=64)
    engines = {
        "triton": lambda r, w, h: raster_triton.render_raster_triton(scene, r, tr, w, h),
        "xla": lambda r, w, h: raster.render_raster_xla(scene, r, tr, w, h),
    }
    for w, h in [(512, 512), (1920, 1080)]:
        rays = camera.generate_rays(cam, w, h)
        hits = {}
        # alternate the engines so drift in clocks hits both alike
        times = {k: [] for k in engines}
        try:
            for k, f in engines.items():
                hits[k] = jax.block_until_ready(f(rays, w, h))
            for _ in range(10):
                for k, f in engines.items():
                    t0 = time.perf_counter()
                    jax.block_until_ready(f(rays, w, h))
                    times[k].append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # report an engine that cannot run this frame
            print(f"{w}x{h}: engine failed: {e!r}"[:600], flush=True)
            continue
        same = np.array_equal(np.asarray(hits["triton"][0].prim_idx),
                              np.asarray(hits["xla"][0].prim_idx))
        for k in engines:
            print(f"{w}x{h} {k}: median {np.median(times[k]):.3f} ms, min "
                  f"{min(times[k]):.3f} ms, overflow={bool(hits[k][2])} [{card}]",
                  flush=True)
        print(f"{w}x{h}: same prim ids in both engines: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
