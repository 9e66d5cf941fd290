"""Drive the library end-to-end through its public API: load the cornellbox,
build both LBVH variants, collapse, traverse with all four variants, render
PNGs into renders/.

    PYTHONPATH=. python tools/e2e_drive.py
"""
import os, time
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp

from jax_bvh.utils import scenes, camera, image
from jax_bvh.models import lbvh
from jax_bvh.ops import traverse, collapse
from jax_bvh.utils.cost import sah_cost_bvh2, sah_cost_bvh4
from jax_bvh.ops.aabb import triangle_aabbs

tris_np = scenes.cornellbox()
print("cornellbox tris:", tris_np.shape)
tris = jnp.asarray(tris_np)

os.makedirs("renders", exist_ok=True)
t, cam = scenes.preset("cornellbox")
W = H = 256
rays = camera.generate_rays(cam, W, H)

for name, build in [("two_pass", lbvh.build_two_pass), ("single_pass", lbvh.build_single_pass)]:
    bvh = build(tris)
    c2 = float(sah_cost_bvh2(bvh))
    b4 = collapse.collapse_bvh2_to_bvh4(bvh)
    pa_min, pa_max = triangle_aabbs(tris)
    c4 = float(sah_cost_bvh4(b4, pa_min, pa_max))
    print(f"{name}: root={int(bvh.root)} sah_bvh2={c2:.4f} sah_bvh4={c4:.4f} wide_nodes={int(b4.n_nodes)}")

bvh = lbvh.build_two_pass(tris)
hits = {}
for variant in ["if_if", "while_while", "speculative", "restart_trail"]:
    t0 = time.time()
    hit, counts = traverse.traverse_bvh2(bvh, tris, rays, t, variant=variant)
    hit = jax.tree.map(np.asarray, hit)
    hits[variant] = hit
    n_hit = int((hit.prim_idx >= 0).sum())
    print(f"{variant}: hits={n_hit}/{W*H} mean_leaf_visits={float(np.asarray(counts).mean()):.2f} ({time.time()-t0:.1f}s)")

base = hits["speculative"]
for v, h in hits.items():
    assert np.array_equal(h.prim_idx, base.prim_idx), f"{v} prim mismatch"
    assert np.allclose(h.t[base.prim_idx>=0], base.t[base.prim_idx>=0], rtol=1e-5), f"{v} t mismatch"
print("all 4 traversal variants agree")

img = image.shade_barycentric(base.prim_idx, base.u, base.v, W, H)
image.write_png("renders/cornell_render.png", img)
hm = image.heatmap(counts, W, H)
image.write_png("renders/cornell_heatmap.png", hm)
print("wrote renders/cornell_render.png renders/cornell_heatmap.png")

# raster fast path must agree with the wavefront engines
from jax_bvh.ops import raster

packed = raster.pack_raster(bvh, tris, leaf_size=16)
hit_r, counts_r, overflow = raster.render_raster_xla(
    packed, rays, t, W, H, tile=16, cap_a=8, cap_b=64, tiles_b=32
)
hit_r = jax.tree.map(np.asarray, hit_r)
assert not bool(overflow), "raster bin overflow"
hm = (base.prim_idx >= 0)
assert np.array_equal(hit_r.prim_idx >= 0, hm), "raster hit-mask mismatch"
tied = hm & (hit_r.prim_idx != base.prim_idx)
assert np.allclose(hit_r.t[hm], base.t[hm], rtol=1e-4), "raster t mismatch"
assert tied.sum() <= 0.001 * hm.sum() + 2, f"raster prim mismatches: {tied.sum()}"
img_r = image.shade_barycentric(hit_r.prim_idx, hit_r.u, hit_r.v, W, H)
image.write_png("renders/cornell_raster.png", img_r)
print(f"raster agrees (ties: {int(tied.sum())}); wrote renders/cornell_raster.png")

# Triton raster kernel (interpret mode) at reduced res
from jax_bvh.ops import raster_triton

Wk = Hk = 128
rays_k = camera.generate_rays(cam, Wk, Hk)
hit_k, _ck, ovf_k = raster_triton.render_raster_triton(
    packed, rays_k, t, Wk, Hk, cand_cap=64, interpret=True,
)
hit_ok, _ = traverse.traverse_bvh2(bvh, tris, rays_k, t, variant="speculative")
hk = np.asarray(hit_k.prim_idx)
ho = np.asarray(hit_ok.prim_idx)
assert not bool(ovf_k)
assert np.array_equal(hk >= 0, ho >= 0), "raster kernel hit-mask mismatch"
mask = hk >= 0
assert np.allclose(
    np.asarray(hit_k.t)[mask], np.asarray(hit_ok.t)[mask], rtol=1e-4
), "raster kernel t mismatch"
print("raster kernel agrees (interpret mode)")
