"""Multi-device CPU scaling smoke table.

Runs on the CPU backend with 8 virtual devices (set below). Times the
sharded batched build and the sharded single-scene build at 2/4/8 virtual
devices — wall clock only: virtual devices share one socket, so this shows
readiness and the overhead trend, not a device speedup.

    PYTHONPATH=. python tools/scaling_table.py
"""
import os
import sys
import time

sys.path.insert(0, ".")

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    devs = jax.devices()
    if devs[0].platform != "cpu" or len(devs) < 8:
        print(f"scaling table: need 8 CPU devices, got {devs}", flush=True)
        return

    from jax.sharding import Mesh

    from jax_bvh.models import batched, lbvh
    from jax_bvh.parallel import sharded, sharded_build
    from jax_bvh.utils import scenes

    soup = np.asarray(scenes.bunny_like(8192), np.float32)
    # procedural scenes round the count to their grid; trim to a multiple
    # of 8 so every mesh width divides it (the sharded build requires it)
    n_tris = soup.shape[0] - soup.shape[0] % 8
    soup = jnp.asarray(soup[:n_tris])
    n_meshes = 128
    base = np.asarray(scenes.cornellbox(), np.float32)
    tris_b = jnp.asarray(np.broadcast_to(base, (n_meshes, *base.shape)).copy())

    def timeit(f, reps=3):
        jax.block_until_ready(f())  # compile
        best = min(
            (lambda t0: (jax.block_until_ready(f()), time.perf_counter() - t0)[1])(
                time.perf_counter()
            )
            for _ in range(reps)
        )
        return best * 1e3

    print("multi-device CPU scaling (virtual devices, wall ms):", flush=True)
    print(f"  devices | batched {n_meshes}x32 | sharded single-scene "
          f"{n_tris} | exact", flush=True)
    want = lbvh.build_single_pass(soup)
    for p in (2, 4, 8):
        mesh = Mesh(np.array(devs[:p]), ("dp",))
        # jit the eager shard_map pipelines: un-jitted they re-trace and
        # dispatch op-by-op every call (r4: 88 s/rep -> ms/rep)
        fb = jax.jit(lambda t, mesh=mesh: sharded.build_batched_sharded(mesh, t))
        fs = jax.jit(
            lambda t, mesh=mesh: sharded_build.build_single_pass_sharded(mesh, t)
        )
        t_b = timeit(lambda: fb(tris_b))
        t_s = timeit(lambda: fs(soup))
        sb = jax.block_until_ready(fs(soup))
        got = sharded_build.to_bvh2(sb, n_tris)
        exact = (
            not bool(sb.overflow)
            and np.array_equal(np.asarray(got.left), np.asarray(want.left))
            and np.array_equal(
                np.asarray(got.node_min), np.asarray(want.node_min)
            )
        )
        print(
            f"  {p:7d} | {t_b:11.1f} ms | {t_s:21.1f} ms | {exact}",
            flush=True,
        )


if __name__ == "__main__":
    main()
