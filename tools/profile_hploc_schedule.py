"""HPLOC prefix-schedule sweep: SAH + merge-round count per (shift0, step).

Runs on the CPU; the trees are the same on every backend. Round count is
the cost proxy: each round costs about the live cluster width.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from jax_bvh.models import lbvh
from jax_bvh.models.ploc import _build
from jax_bvh.utils import scenes
from jax_bvh.utils.cost import sah_cost_bvh2


def rounds_to_finish(tris, shift0, shift_step):
    """Count merge rounds by stepping the XLA _round loop manually."""
    from jax import lax
    from jax_bvh.ops import ploc as P

    refs = lbvh.prim_refs_from_triangles(jnp.asarray(tris))
    codes, leaf_packed_t, _ = lbvh._sorted_leaves_packed(refs, True)
    n = int(codes.shape[0])
    init_nodes = jnp.arange(n, dtype=jnp.int32) + (n - 1)
    mat = jnp.concatenate(
        [
            lax.bitcast_convert_type(leaf_packed_t, jnp.int32),
            codes.astype(jnp.int32)[None, :],
            init_nodes[None, :],
        ],
        axis=0,
    )
    nodes = jnp.zeros((8, (n - 1) + max(n + 512, 16896)), jnp.int32)
    state = (jnp.asarray(n, jnp.int32), jnp.asarray(shift0, jnp.int32), mat, nodes)
    rounds = 0
    widths = 0
    while int(state[0]) > 1:
        state = P._round(state, n, 8, shift_step)
        rounds += 1
        widths += int(state[0])
        if rounds > 200:
            break
    return rounds, widths


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    tris = jnp.asarray(scenes.sponza_like(n))
    for shift0, step in [(32, 3), (9, 6), (12, 6), (12, 9), (15, 9),
                         (15, 12), (18, 12), (9, 9), (6, 6)]:
        b = _build(tris, True, hploc=(shift0 != 32),
                   shift0=shift0, shift_step=step)
        c = float(sah_cost_bvh2(b))
        r, w = rounds_to_finish(np.asarray(tris), shift0 if shift0 != 32 else 32, step)
        print(f"shift0={shift0:3d} step={step:3d}: sah={c:9.2f} "
              f"rounds={r:3d} sum_widths={w}", flush=True)


if __name__ == "__main__":
    main()
