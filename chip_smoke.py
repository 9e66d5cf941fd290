"""End-to-end check of the main path on a GPU: build -> collapse -> render.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the sharded paths only

One GPU, at the reference's scene sizes (`scenes.sponza_like(262_000)` and
`scenes.bunny_like(150_000)`, the stand-ins for Sponza 260K / Bunny 150K):

* the four device builders on sponza_like and the two LBVH builders on
  bunny_like, plus the 4096 x 32 batched build;
* the XLA stages under the LBVH builders (topology scans, window refit);
* BVH2 -> BVH4 collapse (slab BFS, and the analytic specification);
* primary rays at 512^2 and 1920x1080 through the raster engine, checked
  against the wavefront engine at 512^2;
* the 1080p shadow-ray set through the sweep engine (forward on a 64K
  strided slice, reversed on every live ray), checked against the
  tmax-capped wavefront answer;
* the demo app (`python -m jax_bvh.app ... --traversal raster`) in-process;
* the `gpu`-marked tests of tests/test_gpu.py, called in-process.

Every phase prints its warm host-clock time around `block_until_ready`
(median of a few calls after one compiling call) beside the card's name and
power limit, and every check prints its tolerance. The last line of stdout
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
The script exits non-zero, printing no such line, when JAX finds no GPU or
any phase fails. It runs in one process.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPS = 5
# Scene and frame sizes of the one-card path; SAH pins hold at these sizes.
FULL = {"sponza": 262_000, "bunny": 150_000, "meshes": 4096, "oracle": 16_384,
        "frames": ((512, 512), (1920, 1080)), "slice": 65536}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Smoke:
    """Runs phases, prints their times, and records check failures."""

    def __init__(self, card_name: str):
        self.card = card_name
        self.failed: list[str] = []

    def time(self, name: str, fn, reps: int = REPS):
        """Compile once, then print the median warm time; returns fn()."""
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        print(f"time {name}: {np.median(ts) * 1e3:.3f} ms warm (median of "
              f"{reps}; first call {first:.1f} s) [{self.card}]", flush=True)
        return out

    def check(self, name: str, ok: bool, rule: str) -> None:
        print(f"check {name}: {'pass' if ok else 'FAIL'} ({rule})", flush=True)
        if not ok:
            self.failed.append(name)


def sah_check(sm: Smoke, name: str, value: float, pin: float) -> None:
    sm.check(
        f"{name}_sah", abs(value - pin) <= 0.01 * abs(pin),
        f"SAH {value:.2f} within 1% of pin {pin:.2f}: XLA:GPU may contract the "
        "Morton normalisation into FMAs, which can move a few codes",
    )


def hit_rule(sm: Smoke, name, hit, ref) -> None:
    """Same hit mask; t within rtol 1e-4; a different prim only where the
    two t tie within rtol 1e-3."""
    pk, po = np.asarray(hit.prim_idx), np.asarray(ref.prim_idx)
    tk, to = np.asarray(hit.t), np.asarray(ref.t)
    both = pk >= 0
    mask_diff = int(((pk >= 0) != (po >= 0)).sum())
    t_ok = np.allclose(tk[both], to[both], rtol=1e-4)
    diff = both & (pk != po)
    ties_ok = np.allclose(tk[diff], to[diff], rtol=1e-3) if diff.any() else True
    print(f"  {name}: {int(both.sum())} hits, {int((both & (pk == po)).sum())} "
          f"same prim, {int(diff.sum())} t-tied prims, {mask_diff} mask "
          "differences", flush=True)
    if mask_diff:
        print(f"  {name}: {mask_diff} pixels hit in one engine only — silhouette "
              "pixels where FMA contraction flips a barycentric sign test",
              flush=True)
    sm.check(name, mask_diff == 0 and t_ok and ties_ok,
             "same hit mask, t rtol 1e-4, other prim only on t ties within "
             "rtol 1e-3; fixed-eye coefficients reassociate the wavefront "
             "engine's arithmetic and both may contract into FMAs; no float32 "
             "matrix product runs here, so TF32 does not apply")


def one_card(sm: Smoke, size: dict = FULL) -> None:
    import jax
    import jax.numpy as jnp

    from jax_bvh import app, config
    from jax_bvh.models import batched, lbvh, ploc
    from jax_bvh.ops import collapse, collapse_analytic, radix_tree, raster
    from jax_bvh.ops import ray_sweep, refit, traverse
    from jax_bvh.ops.aabb import triangle_aabbs
    from jax_bvh.types import Rays
    from jax_bvh.utils import camera, cpu_reference, scenes, validate
    from jax_bvh.utils.cost import SAH_PINS, sah_cost_bvh2, sah_cost_bvh4

    builders = {
        "single_pass": lbvh.build_single_pass,
        "two_pass": lbvh.build_two_pass,
        "ploc": ploc.build_ploc,
        "hploc": ploc.build_hploc,
    }
    trees = {}
    # PLOC/HPLOC compile for minutes per scene size on the GPU, so they run
    # on sponza_like only (bench.py covers bunny_like)
    for scene_name, tris_np, names in [
        ("sponza_like", scenes.sponza_like(size["sponza"]), builders),
        ("bunny_like", scenes.bunny_like(size["bunny"]), ("single_pass", "two_pass")),
    ]:
        tris = jnp.asarray(tris_np)
        n = int(tris.shape[0])
        print(f"scene {scene_name}: {n} triangles", flush=True)
        for name in names:
            build = builders[name]
            bvh = sm.time(f"build {scene_name}/{name}", lambda: build(tris))
            ok = validate.check_root_aabb(bvh) and validate.check_bvh2_correctness(bvh, n)
            sm.check(f"{scene_name}/{name}_structure", ok,
                     "root AABB equals the leaf union; every prim once (exact)")
            if size is FULL:
                sah_check(sm, f"{scene_name}/{name}", float(sah_cost_bvh2(bvh)),
                          SAH_PINS[scene_name][name])
            trees[(scene_name, name)] = bvh

    tris = jnp.asarray(scenes.sponza_like(size["sponza"]))
    n = int(tris.shape[0])

    # ---- the XLA stages under the builders, at sponza scale ----
    codes, leaf_t, _prim = jax.jit(lambda t: lbvh._sorted_leaves_from_tris(t, True))(tris)
    scans = jax.jit(radix_tree._topology_scans)
    window = jax.jit(refit.refit_anchored_packed)
    _d, first, last, *_ = sm.time("stage topology scans (sponza_like)", lambda: scans(codes))
    sm.time("stage window refit (sponza_like)", lambda: window(leaf_t, first, last))

    # ---- batched tiny meshes ----
    rng = np.random.default_rng(0)
    meshes = [(rng.normal(size=(32, 3, 3)) * 0.3 + rng.normal(size=(1, 1, 3)))
              .astype(np.float32) for _ in range(size["meshes"])]
    tris_b = jnp.asarray(batched.pad_meshes(meshes, capacity=32)[0])
    bvhs = sm.time(f"build batched {size['meshes']}x32",
                   lambda: batched.build_batched(tris_b))
    ok = True
    for i in range(0, size["meshes"], size["meshes"] // 8):
        one = type(bvhs)(*[np.asarray(f)[i] for f in bvhs])
        want = lbvh.build_single_pass(tris_b[i], use_extended=False)
        ok &= validate.check_bvh2_correctness(one, 32)
        ok &= all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(one, want))
    sm.check("batched_matches_single_pass", bool(ok),
             "8 sampled meshes bit-identical to the single-pass builder (exact)")

    # ---- BVH2 -> BVH4 collapse ----
    bvh = trees[("sponza_like", "single_pass")]
    wide = sm.time("collapse slab BFS (sponza_like/single_pass)",
                   lambda: collapse.collapse_bvh2_to_bvh4(bvh))
    sm.check("bvh4_structure", validate.check_bvh4_correctness(wide, n),
             "every prim once under the BVH4 root (exact)")
    pmn, pmx = triangle_aabbs(tris)
    if size is FULL:
        sah_check(sm, "sponza_like/bvh4", float(sah_cost_bvh4(wide, pmn, pmx)),
                  SAH_PINS["sponza_like"]["bvh4"])
    wide_a = sm.time("collapse analytic (sponza_like/single_pass)",
                     lambda: collapse_analytic.collapse_bvh2_to_bvh4_analytic(bvh), reps=2)
    k = int(wide.n_nodes)
    sm.check("analytic_equals_bfs",
             int(wide_a.n_nodes) == k
             and np.array_equal(np.asarray(wide_a.child)[:k], np.asarray(wide.child)[:k]),
             "same wide nodes and children as the slab BFS (exact)")
    small = lbvh.build_single_pass(jnp.asarray(scenes.sponza_like(size["oracle"])))
    got, want = collapse.collapse_bvh2_to_bvh4(small), cpu_reference.collapse_cpu(small)
    kk = want["n_nodes"]
    used = np.arange(4)[None, :] < want["child_count"][:kk][:, None]
    ok = int(got.n_nodes) == kk
    for f in ("child", "parent", "child_count"):
        ok &= np.array_equal(np.asarray(getattr(got, f))[:kk], want[f][:kk])
    for f in ("leaf_prim", "leaf_parent"):
        ok &= np.array_equal(np.asarray(getattr(got, f)), want[f])
    for f in ("child_min", "child_max"):
        ok &= np.array_equal(np.asarray(getattr(got, f))[:kk][used], want[f][:kk][used])
    sm.check("collapse_16k_equals_cpu_oracle", bool(ok),
             "every array equal to utils.cpu_reference.collapse_cpu (exact)")

    # ---- primary rays ----
    tr, cam = scenes.preset("sponza")
    scene = raster.pack_raster(bvh, tris, leaf_size=64)
    print(f"raster engine: {raster.raster_engine()}", flush=True)
    packed = traverse.pack_bvh2(bvh, tris)
    hits = {}
    (w0, h0), (w1, h1) = size["frames"]
    for w, h in size["frames"]:
        rays = camera.generate_rays(cam, w, h)
        hit, _c, ovf = sm.time(f"render raster {w}x{h}",
                               lambda: raster.render_raster(scene, rays, tr, w, h))
        sm.check(f"raster_{w}x{h}_no_overflow", not bool(ovf),
                 "candidate list within cand_cap 1024 (exact)")
        hits[(w, h)] = (rays, hit)
    rays, hit = hits[(w0, h0)]
    ref, _ = sm.time(f"traverse wavefront {w0}x{h0}",
                     lambda: traverse.traverse_packed(packed, bvh.n_internal, bvh.root, rays, tr),
                     reps=2)
    hit_rule(sm, f"raster_{w0}x{h0}_matches_wavefront", hit, ref)

    # ---- shadow rays from the second frame's primary hits ----
    rays_f, hit_f = hits[(w1, h1)]
    tb = tris.reshape(-1, 3)
    smin3, smax3 = np.asarray(jnp.min(tb, axis=0)), np.asarray(jnp.max(tb, axis=0))
    diag = float(np.linalg.norm(smax3 - smin3))
    light = jnp.asarray([(smin3[0] + smax3[0]) * 0.5, smax3[1] + 0.1 * diag,
                         (smin3[2] + smax3[2]) * 0.5], jnp.float32)
    eps = 1e-3 * diag
    live_idx = np.nonzero(np.asarray(hit_f.prim_idx) >= 0)[0]
    sel = jnp.asarray(live_idx, jnp.int32)
    points = rays_f.origin[sel] + rays_f.direction[sel] * hit_f.t[sel][:, None]
    dvec = light[None, :] - points
    dist = jnp.linalg.norm(dvec, axis=1)
    dl = dvec / jnp.maximum(dist, 1e-9)[:, None]
    srays = Rays(origin=points + dl * eps, direction=dl,
                 tmin=jnp.zeros_like(dist), tmax=dist - 2 * eps)
    nv = min(size["slice"], live_idx.size)
    vsel = jnp.asarray(np.linspace(0, live_idx.size - 1, nv).astype(np.int32))
    srays_v = Rays(*(f[vsel] for f in srays))
    print(f"shadow rays: {live_idx.size} live of {w1 * h1}; strided slice {nv}",
          flush=True)
    hit_s, _c, ovf_s = sm.time(f"shadow sweep forward ({nv} rays)",
                               lambda: ray_sweep.trace_rays(scene, srays_v, tr, cand_cap=4096))
    live = jnp.ones((live_idx.size,), bool)
    occ_r, _c, ovf_r = sm.time(
        f"shadow sweep reversed ({live_idx.size} rays)",
        lambda: ray_sweep.shadow_occlusion(scene, points, live, light, tr, eps,
                                           cand_cap=4096))
    sm.check("shadow_no_overflow", not bool(ovf_s) and not bool(ovf_r),
             "candidate lists within cand_cap 4096 (exact)")
    ref_s, _ = sm.time(f"traverse wavefront shadow slice ({nv} rays)",
                       lambda: traverse.traverse_packed(packed, bvh.n_internal, bvh.root,
                                                        srays_v, tr), reps=2)
    ps, ts = np.asarray(hit_s.prim_idx), np.asarray(hit_s.t)
    po, to = np.asarray(ref_s.prim_idx), np.asarray(ref_s.t)
    tmax = np.asarray(srays_v.tmax)
    occ = (po >= 0) & (to < tmax)
    to_safe = np.where(po >= 0, to, np.inf)
    boundary = (np.abs(to_safe - tmax) < 10 * eps) | (to_safe < 10 * eps)
    mism = ((ps >= 0) != occ) & ~boundary
    both = (ps >= 0) & occ
    t_ok = np.allclose(ts[both], to[both], rtol=1e-3, atol=1e-3)
    dmask = both & (ps != po)
    ties_ok = np.allclose(ts[dmask], to[dmask], rtol=1e-3, atol=1e-3) if dmask.any() else True
    print(f"  shadow forward: {int(occ.sum())} occluded, {int(both.sum())} found, "
          f"{int(mism.sum())} mask differences outside the boundary strips "
          f"({int(boundary.sum())} rays in them)", flush=True)
    rule = ("occluded mask equal outside the strips |t - tmax| < 10 eps and "
            "t < 10 eps, where grazing the segment ends flips with rounding; "
            "t within rtol 1e-3 atol 1e-3; other prim only on such t ties")
    sm.check("shadow_forward_matches_wavefront", not mism.any() and t_ok and ties_ok, rule)
    occ_rev = np.asarray(occ_r)[np.asarray(vsel)]
    rmism = (occ_rev != occ) & ~boundary
    print(f"  shadow reversed: {int(rmism.sum())} mask differences outside the strips",
          flush=True)
    sm.check("shadow_reversed_matches_wavefront", not rmism.any(), rule)

    # ---- the demo app through its CLI entry point ----
    if size is not FULL:
        return
    os.makedirs("renders", exist_ok=True)
    t0 = time.perf_counter()
    res = app.run(config.parse_args([
        "--builder", "single_pass", "--scene", "sponza_like",
        "--traversal", "raster", "--out", "renders/app_sponza.png",
    ]))
    print(f"time app single_pass/sponza_like/raster: {time.perf_counter() - t0:.1f} s "
          f"cold, total {res['total_ms']:.3f} ms [{sm.card}]", flush=True)
    sm.check("app_ran", os.path.getsize("renders/app_sponza.png") > 0,
             "the app wrote its PNG")


def gpu_tests(sm: Smoke) -> None:
    """Run the `gpu`-marked tests of tests/test_gpu.py in this process."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_gpu.py")
    spec = importlib.util.spec_from_file_location("test_gpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in sorted(n for n in vars(mod) if n.startswith("test_")):
        t0 = time.perf_counter()
        try:
            getattr(mod, name)()
            ok, why = True, "passed"
        except AssertionError as e:
            ok, why = False, str(e).splitlines()[0] if str(e) else "assertion"
        print(f"  {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        sm.check(f"gpu_test {name}", ok, why)


def _spread(name, arr, sm: Smoke, sharded: bool) -> None:
    """Every output leaf has one shard on each of the mesh's devices, and
    dp-sharded outputs are not replicated."""
    import jax

    for leaf in jax.tree.leaves(arr):
        devs = {s.device.id for s in leaf.addressable_shards}
        ok = len(devs) == 4 and len(leaf.addressable_shards) == 4
        if sharded:
            ok &= not leaf.sharding.is_fully_replicated
        if not ok:
            sm.check(f"{name}_spread", False, "one shard on each of 4 devices")
            return
    sm.check(f"{name}_spread", True, "one shard on each of 4 devices")


def four_cards(sm: Smoke, n_tris: int = 262_000, side: int = 512,
               n_meshes: int = 4096) -> None:
    """The sharded public API on a 1-D 'dp' mesh of four devices, each
    compared with its one-device counterpart."""
    import jax
    import jax.numpy as jnp

    from jax_bvh.models import batched, lbvh
    from jax_bvh.ops import raster, traverse
    from jax_bvh.parallel import sharded, sharded_build
    from jax_bvh.utils import camera, scenes

    mesh = sharded.default_mesh(4)
    print(f"mesh: {mesh.devices.tolist()}", flush=True)

    rng = np.random.default_rng(0)
    meshes = [(rng.normal(size=(32, 3, 3)) * 0.3 + rng.normal(size=(1, 1, 3)))
              .astype(np.float32) for _ in range(n_meshes)]
    tris_b = batched.pad_meshes(meshes, capacity=32)[0]
    got = sm.time(f"sharded batched build {n_meshes}x32",
                  lambda: sharded.build_batched_sharded(mesh, tris_b))
    want = batched.build_batched(jnp.asarray(tris_b))
    _spread("batched", got, sm, sharded=True)
    sm.check("batched_equals_one_device",
             all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want)),
             "bit-identical to the one-device batched build")

    tris_np = scenes.sponza_like(n_tris)
    tris_np = tris_np[: tris_np.shape[0] - tris_np.shape[0] % 4]
    tris = jnp.asarray(tris_np)
    lo, hi = sm.time("sharded scene extents",
                     lambda: sharded.sharded_scene_extents(mesh, tris))
    _spread("extents", (lo, hi), sm, sharded=False)
    flat = tris_np.reshape(-1, 3)
    sm.check("extents_equal",
             np.array_equal(np.asarray(lo), flat.min(axis=0))
             and np.array_equal(np.asarray(hi), flat.max(axis=0)),
             "min/max equal to numpy (exact)")

    bvh = lbvh.build_single_pass(tris)
    tr, cam = scenes.preset("sponza")
    rays = camera.generate_rays(cam, side, side)
    hit_s, _c = sm.time(f"sharded wavefront traversal {side}x{side}",
                        lambda: sharded.traverse_sharded(mesh, bvh, tris, rays, tr), reps=2)
    _spread("traverse", hit_s, sm, sharded=True)
    hit_1, _ = traverse.traverse_bvh2(bvh, tris, rays, tr, variant="speculative")
    sm.check("traverse_equals_one_device",
             np.array_equal(np.asarray(hit_s.prim_idx), np.asarray(hit_1.prim_idx))
             and np.array_equal(np.asarray(hit_s.t), np.asarray(hit_1.t)),
             "prim and t bit-identical to one device")

    scene = raster.pack_raster(bvh, tris, leaf_size=64)
    hit_1, _c, _o = raster.render_raster(scene, rays, tr, side, side)
    hit_r = sm.time(f"sharded raster {side}x{side}",
                    lambda: sharded.render_raster_sharded(mesh, scene, rays, tr, side, side))
    _spread("raster", hit_r, sm, sharded=True)
    sm.check("raster_equals_one_device",
             np.array_equal(np.asarray(hit_r.prim_idx), np.asarray(hit_1.prim_idx))
             and np.array_equal(np.asarray(hit_r.t), np.asarray(hit_1.t)),
             "strips cut on coarse-tile edges: bit-identical to one device")

    sb = sm.time(f"sharded single-pass build ({tris_np.shape[0]} tris)",
                 lambda: sharded_build.build_single_pass_sharded(mesh, tris), reps=1)
    _spread("sharded_build", (sb.int_packed, sb.leaf_packed, sb.left, sb.right,
                              sb.leaf_prim), sm, sharded=True)
    sm.check("sharded_build_no_overflow", not bool(sb.overflow), "routing capacity held")
    got = sharded_build.to_bvh2(sb, tris_np.shape[0])
    want = lbvh.build_single_pass(tris)
    sm.check("sharded_build_equals_one_device",
             np.array_equal(np.asarray(got.left), np.asarray(want.left))
             and np.array_equal(np.asarray(got.right), np.asarray(want.right))
             and np.array_equal(np.asarray(got.node_min), np.asarray(want.node_min))
             and np.array_equal(np.asarray(got.node_max), np.asarray(want.node_max))
             and int(got.root) == int(want.root),
             "left/right/AABBs/root bit-identical to lbvh.build_single_pass")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded paths on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform}); nothing run",
              file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devs)}", file=sys.stderr)
        return 1

    from jax_bvh.config import use_compile_cache

    use_compile_cache()
    sm = Smoke(card())
    print(sm.card, flush=True)
    print(f"jax {jax.__version__}; devices {devs}", flush=True)
    if args.four:
        four_cards(sm)
    else:
        gpu_tests(sm)
        one_card(sm)
    if sm.failed:
        print(f"chip_smoke: {len(sm.failed)} checks failed: {sm.failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
