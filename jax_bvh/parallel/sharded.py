"""Multi-chip scaling over a `jax.sharding.Mesh`.

The reference is single-GPU (device 0 hard-coded, `Context.cpp:11`); its
natural scaling axes become SPMD shardings here (SURVEY.md §2 item 5 and
§5 "long-context" notes):

* batch parallelism — one BVH per mesh, meshes sharded across chips
  (`build_batched_sharded`); purely local compute, embarrassingly parallel.
* primitive sharding — a single huge scene's triangles sharded across
  devices; scene extents become `lax.pmin/pmax` collectives
  (`sharded_scene_extents`), the analog of the reference's global
  `atomicGrow` reduction (`CommonBlocksKernel.h:92-137`).
* ray parallelism — rays sharded, BVH replicated (`traverse_sharded`);
  each chip shades its tile independently (the multi-chip render path).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import batched
from ..ops import aabb as A
from ..ops import traverse
from ..types import Rays


def default_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis,))


def build_batched_sharded(mesh: Mesh, tris_b):
    """Shard the mesh batch over the 'dp' axis; each device builds its local
    BVHs with zero communication."""
    return _build_batched(jax.device_put(tris_b, NamedSharding(mesh, P("dp"))), mesh)


# Each public function below jits its shard_map, so the mesh runs one
# compiled program instead of dispatching the body op by op.
@partial(jax.jit, static_argnames=("mesh",))
def _build_batched(tris_b, mesh):
    return jax.shard_map(
        batched.build_batched, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
        check_vma=False,
    )(tris_b)


def sharded_scene_extents(mesh: Mesh, tris):
    """Scene AABB of a triangle array sharded over 'dp': local min/max then
    an all-reduce (`lax.pmin`/`pmax`) — deterministic, unlike the
    reference's float atomics."""
    return _extents(jax.device_put(tris, NamedSharding(mesh, P("dp"))), mesh)


@partial(jax.jit, static_argnames=("mesh",))
def _extents(tris, mesh):
    @partial(
        jax.shard_map, mesh=mesh, in_specs=P("dp"), out_specs=P(), check_vma=False
    )
    def _local(local):
        mn, mx = A.triangle_aabbs(local)
        lo = jnp.min(mn, axis=0)
        hi = jnp.max(mx, axis=0)
        return lax.pmin(lo, "dp"), lax.pmax(hi, "dp")

    return _local(tris)


def traverse_sharded(mesh: Mesh, bvh, tris, rays: Rays, tr, variant="speculative"):
    """Rays sharded over 'dp', BVH + triangles replicated: the multi-chip
    render. Returns sharded HitInfo + leaf-visit counts."""
    rep = NamedSharding(mesh, P())
    return _trace(
        jax.device_put(bvh, rep), jax.device_put(tris, rep),
        jax.device_put(rays, NamedSharding(mesh, P("dp"))), jax.device_put(tr, rep),
        mesh, variant,
    )


@partial(jax.jit, static_argnames=("mesh", "variant"))
def _trace(bvh, tris, rays, tr, mesh, variant):
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("dp"), P()),
        out_specs=P("dp"),
        check_vma=False,
    )
    def _local(bvh_l, tris_l, rays_l, tr_l):
        return traverse.traverse_bvh2(bvh_l, tris_l, rays_l, tr_l, variant=variant)

    return _local(bvh, tris, rays, tr)


def render_raster_sharded(
    mesh: Mesh,
    scene,
    rays: Rays,
    tr,
    width: int,
    height: int,
):
    """Raster render with the image sharded over 'dp' (vertical strips of
    64-px coarse tiles), scene replicated: each device runs the full raster
    pipeline of `raster.render_raster` (binning + sweep) on its strip with
    zero communication — linear scaling in rays. Returns sharded HitInfo."""
    assert width % (64 * mesh.devices.size) == 0, "width must split into 64px strips"
    ray_sharding = NamedSharding(mesh, P("dp"))
    rep = NamedSharding(mesh, P())
    return _render_strips(
        jax.device_put(scene.tris_sorted, rep),
        jax.device_put(scene.prim_ids, rep),
        jax.device_put(rays, ray_sharding),
        jax.device_put(tr, rep),
        mesh, width, height, scene.n_real, scene.leaf_size,
    )


@partial(jax.jit, static_argnames=("mesh", "width", "height", "n_real", "leaf_size"))
def _render_strips(ts, pids, rays, tr, mesh, width, height, n_real, leaf_size):
    from ..ops import raster

    w_local = width // mesh.devices.size

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("dp"), P()),
        out_specs=P("dp"),
        check_vma=False,
    )
    def _render(ts, pids, rays_l, tr_l):
        local = raster.RasterScene(ts, pids, n_real, leaf_size)
        hit, _c, _ = raster.render_raster(local, rays_l, tr_l, w_local, height)
        return hit

    return _render(ts, pids, rays, tr)
