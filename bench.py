"""Benchmark harness — run on a GPU.

Headline metric (BASELINE.md): full LBVH build (extents + Morton + sort +
topology + refit, the reference's "Total" accounting,
`src/TwoPassLbvh.cpp:308-309`) of a sponza-scale 260K-tri
scene, single-pass builder. Baseline: reference single-pass LBVH Sponza
Total = 0.9886 ms on an RX6800 (`README.md:109-127`).

Timing method: each measured body is iterated K times inside one jit
(`lax.fori_loop`, input perturbed per iteration so nothing is hoisted or
memoized) and the per-iteration time is the slope between two loop
lengths.

Sections are wall-clock-budgeted (`BVH_BENCH_BUDGET_S`, default 3000 s) and
print `SKIPPED (budget)` instead of running past it. A row that raises
ends the run with a non-zero exit code.

Verification gate (the on-device analog of the reference's `_DEBUG`
asserts, `TwoPassLbvh.cpp:145-152`): every builder's tree passes the
structural invariant checkers, the collapsed BVH4 passes its checker and
matches the CPU oracle, and the raster render agrees with the wavefront
engine with no candidate overflow. Any mismatch prints CHECK FAILED and the
run exits non-zero.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": ms, "unit": "ms", "vs_baseline": speedup,
   "verified": bool, "checks_at_emit": n}
(vs_baseline > 1 means faster than the reference). Detail goes to stderr.
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# Reference numbers: README.md:49-211 (RX6800). "Total" excludes collapse.
# Two scenes, like the reference's perf tables: Bunny 150K / Sponza 260K.
BASELINES_MS = {
    "sponza_like": {
        "single_pass": 0.9886,  # README.md:109-127 Sponza Total
        "two_pass": 1.4836,  # README.md:67-85
        "ploc": 1.6410,  # README.md:193-209
        "hploc": 1.3508,  # README.md:151-167
    },
    "bunny_like": {
        "single_pass": 0.9274,  # README.md:87-105 Bunny Total
        "two_pass": 1.1415,  # README.md:49-65
        "ploc": 1.1581,  # README.md:171-189
        "hploc": 1.0222,  # README.md:129-147
    },
}
REF_PHASES_MS = {  # single-pass sponza per-phase, README.md:109-127
    "extents": 0.2249,
    "morton": 0.0853,
    "sort": 0.2496,
    "build": 0.4288,
}
REF_COLLAPSE_MS = 3.3160  # single-pass sponza, README.md:119
HEADLINE = "single_pass"

T0 = time.monotonic()
BUDGET_S = float(os.environ.get("BVH_BENCH_BUDGET_S", "3000"))


def remaining() -> float:
    return BUDGET_S - (time.monotonic() - T0)


def budget_ok(section: str, need_s: float) -> bool:
    """True if `section` fits in the remaining wall clock; else prints a
    loud SKIPPED marker (the artifact records the skip, not a SIGKILL)."""
    if remaining() >= need_s:
        return True
    print(
        f"SECTION SKIPPED (budget): {section} needs ~{need_s:.0f}s, "
        f"{remaining():.0f}s left of {BUDGET_S:.0f}s",
        file=sys.stderr,
        flush=True,
    )
    return False


def check_sah(name: str, value: float, pin: float | None) -> None:
    if pin is None:
        return
    ok = abs(value - pin) <= 0.01 * abs(pin)
    if not ok:
        print(f"SAH drift: {name} {value:.2f} vs pin {pin:.2f}", file=sys.stderr)
    check(f"{name}_sah_pin", ok)

CHECKS: list[tuple[str, bool]] = []


def check(name: str, ok: bool) -> None:
    CHECKS.append((name, bool(ok)))
    if not ok:
        print(f"CHECK FAILED: {name}", file=sys.stderr, flush=True)


def _slope_stats(loop_fn, k_lo=2, k_hi=12, reps=3):
    """Per-iteration ms via the slope between two in-jit loop lengths,
    with run-to-run spread.

    `loop_fn(k)` runs the measured body k times inside one jit; k is a
    TRACED scalar so both loop lengths share ONE compiled executable.
    Returns (best_ms, spread_pct): best = slope of the per-length minima;
    spread = (worst paired slope - best paired slope) / best."""
    f = jax.jit(loop_fn)
    klo = jnp.asarray(k_lo, jnp.int32)
    khi = jnp.asarray(k_hi, jnp.int32)
    np.asarray(f(klo))
    np.asarray(f(khi))
    los = [_t(lambda: f(klo)) for _ in range(reps)]
    his = [_t(lambda: f(khi)) for _ in range(reps)]
    dk = k_hi - k_lo
    best = (min(his) - min(los)) / dk * 1e3
    pair = sorted((h - l) / dk * 1e3 for h, l in zip(his, los))
    spread = (pair[-1] - pair[0]) / best * 100.0 if best > 0 else 0.0
    return best, spread


def _slope_time(loop_fn, k_lo=2, k_hi=12, reps=3):
    return _slope_stats(loop_fn, k_lo, k_hi, reps)[0]


def _t(f):
    t0 = time.perf_counter()
    np.asarray(f())
    return time.perf_counter() - t0


def _phase_table(tris):
    """Per-phase slope timings matching the reference's report block
    (extents / morton / sort, `README.md:49-65`); build time per builder is
    reported as Total minus this front half."""
    from jax_bvh.models import lbvh
    from jax_bvh.ops import morton as M
    from jax_bvh.ops import sort as tsort

    n = int(tris.shape[0])

    def tri_cols(t):
        t9 = t.reshape(n, 9).T
        mnx = jnp.minimum(jnp.minimum(t9[0], t9[3]), t9[6])
        mny = jnp.minimum(jnp.minimum(t9[1], t9[4]), t9[7])
        mnz = jnp.minimum(jnp.minimum(t9[2], t9[5]), t9[8])
        mxx = jnp.maximum(jnp.maximum(t9[0], t9[3]), t9[6])
        mxy = jnp.maximum(jnp.maximum(t9[1], t9[4]), t9[7])
        mxz = jnp.maximum(jnp.maximum(t9[2], t9[5]), t9[8])
        return mnx, mny, mnz, mxx, mxy, mxz

    def mk_extents(k):
        def body(i, acc):
            t = tris * (1.0 + i.astype(jnp.float32) * 3e-7)
            mnx, mny, mnz, mxx, mxy, mxz = tri_cols(t)
            smin = jnp.stack([jnp.min(mnx), jnp.min(mny), jnp.min(mnz)])
            smax = jnp.stack([jnp.max(mxx), jnp.max(mxy), jnp.max(mxz)])
            return acc + smin[0] + smax[2] + mnx[0]
        return lax.fori_loop(0, k, body, 0.0)

    cols = jax.jit(tri_cols)(tris)
    mnx, mny, mnz, mxx, mxy, mxz = [jax.block_until_ready(c) for c in cols]
    smin = jnp.stack([jnp.min(mnx), jnp.min(mny), jnp.min(mnz)])
    smax = jnp.stack([jnp.max(mxx), jnp.max(mxy), jnp.max(mxz)])
    ext = smax - smin
    safe = jnp.where(ext > 0, ext, 1.0)

    def mk_morton(k):
        def body(i, acc):
            p = i.astype(jnp.float32) * 1e-7
            nx = ((mnx + mxx) * 0.5 + p - smin[0]) / safe[0]
            ny = ((mny + mxy) * 0.5 - smin[1]) / safe[1]
            nz = ((mnz + mxz) * 0.5 - smin[2]) / safe[2]
            codes = M.extended_morton30_cols(nx, ny, nz, ext)
            return acc + codes[0].astype(jnp.float32)
        return lax.fori_loop(0, k, body, 0.0)

    nx = ((mnx + mxx) * 0.5 - smin[0]) / safe[0]
    ny = ((mny + mxy) * 0.5 - smin[1]) / safe[1]
    nz = ((mnz + mxz) * 0.5 - smin[2]) / safe[2]
    codes0 = jax.block_until_ready(
        jax.jit(M.extended_morton30_cols)(nx, ny, nz, ext)
    )
    prim_idx = jnp.arange(n, dtype=jnp.int32)

    def mk_sort(k):
        def body(i, acc):
            c = codes0 + i.astype(jnp.uint32)
            out = tsort.sort_with_payload(
                c, (prim_idx, mnx, mny, mnz, mxx, mxy, mxz)
            )
            return acc + out[0][0].astype(jnp.float32) + out[1][1][0]
        return lax.fori_loop(0, k, body, 0.0)

    def mk_front(k):
        def body(i, acc):
            t = tris * (1.0 + i.astype(jnp.float32) * 3e-7)
            c, lpk, lp = lbvh._sorted_leaves_from_tris(t, True)
            return (acc + c[0].astype(jnp.float32) + lpk[0, 0]
                    + lp[0].astype(jnp.float32))
        return lax.fori_loop(0, k, body, 0.0)

    # wide k spreads: the cheap phases must put enough work between the two
    # loop lengths for the slope to dominate dispatch noise
    phases = {}
    for name, mk, k_hi in [("extents", mk_extents, 96),
                           ("morton", mk_morton, 96),
                           ("sort", mk_sort, 48),
                           ("front", mk_front, 32)]:
        phases[name] = _slope_time(mk, k_lo=2, k_hi=k_hi, reps=5)
    return phases


def main() -> None:
    import subprocess

    from jax_bvh.config import use_compile_cache
    from jax_bvh.models import lbvh, ploc as ploc_models
    from jax_bvh.utils import scenes, validate
    from jax_bvh.utils.cost import SAH_PINS, sah_cost_bvh2, sah_cost_bvh4

    use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device: {dev.device_kind} x{len(jax.devices())}; card: {card}",
          file=sys.stderr, flush=True)

    n_scene = int(os.environ.get("BVH_BENCH_N", 262_000))
    scene_list = [("sponza_like", scenes.sponza_like(n_scene))]
    if not os.environ.get("BVH_BENCH_FAST"):
        scene_list.append(("bunny_like", scenes.bunny_like(150_000)))

    builders = {
        "single_pass": lbvh.build_single_pass,
        "two_pass": lbvh.build_two_pass,
        "ploc": ploc_models.build_ploc,
        "hploc": ploc_models.build_hploc,
    }
    results = {}
    sah2 = {}
    tris = None  # sponza tris survive the loop for collapse/render below
    for scene_name, tris_np in scene_list:
        t_scene = jax.device_put(jnp.asarray(tris_np), dev)
        if scene_name == "sponza_like":
            tris = t_scene
        n = int(t_scene.shape[0])
        print(f"scene: {scene_name} {n} tris", file=sys.stderr, flush=True)

        for name, build in builders.items():
            def build_loop(k, build=build, t_scene=t_scene):
                def body(i, acc):
                    t = t_scene * (1.0 + i.astype(jnp.float32) * 3e-7)
                    bvh = build(t)
                    return acc + bvh.packed_t[0, 0] + bvh.left[0].astype(jnp.float32)
                return lax.fori_loop(0, k, body, 0.0)

            k_hi = 12 if "pass" in name else 4
            ms, spr = _slope_stats(build_loop, k_lo=1, k_hi=k_hi, reps=5)
            results[(scene_name, name)] = ms
            ref_total = BASELINES_MS[scene_name][name]
            print(
                f"{scene_name}/{name}: total {ms:.3f} ms (±{spr:.0f}%) "
                f"vs ref {ref_total:.3f} ms -> {ref_total/ms:.2f}x",
                file=sys.stderr,
                flush=True,
            )

        # ---- on-device structural verification + BVH2 SAH per builder ----
        # (pins are recorded at the default scene sizes only)
        pins = SAH_PINS.get(scene_name, {}) if n in (261996, 149604) else {}
        for name, build in builders.items():
            bvh = jax.block_until_ready(build(t_scene))
            c = float(sah_cost_bvh2(bvh))
            sah2[(scene_name, name)] = c
            ok_root = validate.check_root_aabb(bvh)
            ok_tree = validate.check_bvh2_correctness(bvh, n)
            check(f"{scene_name}_{name}_root_aabb", ok_root)
            check(f"{scene_name}_{name}_bvh2_correct", ok_tree)
            check_sah(f"{scene_name}_{name}", c, pins.get(name))
            print(f"{scene_name}/{name}: sah_bvh2 {c:.2f} verified="
                  f"{ok_root and ok_tree}", file=sys.stderr, flush=True)

        # ---- quality gate: SAH ratio vs the host binned-SAH yardstick ----
        # The reference compares its GPU builders against its CPU binned
        # SAH build (README.md:61-207 relations); these scenes are
        # procedural stand-ins, so the ratio, not the absolute SAH, is gated.
        if budget_ok(f"binned_sah_{scene_name}", 120):
            from jax_bvh.models import binned_sah as _bs

            sbvh = _bs.build_binned_sah(tris_np)
            c_b = float(_bs.sah_cost(sbvh))
            for name in builders:
                ratio = sah2[(scene_name, name)] / c_b
                print(
                    f"{scene_name}/{name}: sah ratio vs binned-SAH "
                    f"{ratio:.3f} (binned {c_b:.2f})",
                    file=sys.stderr, flush=True,
                )
                # LBVH-family trees land within 1.45x of binned SAH on
                # Morton-friendly scenes; PLOC within 1.25x
                lim = 1.45 if "pass" in name else 1.25
                check(f"{scene_name}_{name}_sah_ratio", ratio < lim)
    n = int(tris.shape[0])

    # ---- emit the artifact now: the headline + its verification are done ----
    verified_at_emit = all(ok for _, ok in CHECKS) and bool(CHECKS)
    value = results[("sponza_like", HEADLINE)]
    print(
        json.dumps(
            {
                "metric": "sponza_260k_singlepass_lbvh_build_ms",
                "value": round(value, 4),
                "unit": "ms",
                "vs_baseline": round(
                    BASELINES_MS["sponza_like"][HEADLINE] / value, 4
                ),
                "verified": verified_at_emit,
                "checks_at_emit": len(CHECKS),
            }
        ),
        flush=True,
    )

    # ---- per-phase front table (reference report block analog) ----
    if budget_ok("phase_table", 240):
        phases = _phase_table(tris)
        front_ms = phases["front"]
        ref_front = sum(
            REF_PHASES_MS[k] for k in ("extents", "morton", "sort")
        )
        print("phase table (ms, vs reference single-pass sponza):",
              file=sys.stderr)
        for name in ("extents", "morton", "sort"):
            ours = phases[name]
            ref = REF_PHASES_MS[name]
            print(
                f"  {name:8s} {ours:7.3f}  (ref {ref:.3f} -> "
                f"{ref/ours:5.2f}x)",
                file=sys.stderr,
            )
        print(f"  front    {front_ms:7.3f}  (ref {ref_front:.3f} -> "
              f"{ref_front/front_ms:5.2f}x)", file=sys.stderr, flush=True)

    # ---- BVH2 -> BVH4 collapse (reference: 3.32 ms sponza single-pass) ----
    # The slab BFS (ops/collapse.py) on the single-pass tree, gated against
    # the sequential CPU oracle at an oracle-sized scene.
    if budget_ok("collapse", 300):
        from jax_bvh.ops import collapse as collapse_ops
        from jax_bvh.ops.aabb import triangle_aabbs
        from jax_bvh.utils.cpu_reference import collapse_cpu

        bvh0 = jax.block_until_ready(lbvh.build_single_pass(tris))

        def collapse_loop(k):
            def body(i, acc):
                b = bvh0._replace(
                    packed_t=bvh0.packed_t * (1.0 + i.astype(jnp.float32) * 3e-7)
                )
                wide = collapse_ops.collapse_bvh2_to_bvh4(b)
                # consume every output family so nothing is dead code
                chk = (
                    wide.slot_packed_t[0, 0, 0]
                    + (wide.child_t[0, 0] + wide.child_count[1]
                       + wide.parent[2] + wide.leaf_parent[3]
                       + wide.n_nodes).astype(jnp.float32)
                )
                return acc + chk + i.astype(jnp.float32)

            return lax.fori_loop(0, k, body, 0.0)

        ms, spr = _slope_stats(collapse_loop, k_lo=1, k_hi=4, reps=5)
        print(
            f"collapse(slab BFS): {ms:.3f} ms (±{spr:.0f}%) "
            f"(vs ref {REF_COLLAPSE_MS:.3f} ms -> "
            f"{REF_COLLAPSE_MS/ms:.2f}x)",
            file=sys.stderr,
            flush=True,
        )

        # BVH4 SAH (the reference's regression oracle, Utility.cpp:351-396)
        # + collapse quality-improvement ratio (~2.2x claimed, README.md:19)
        wide = jax.block_until_ready(collapse_ops.collapse_bvh2_to_bvh4(bvh0))
        pmn, pmx = triangle_aabbs(tris)
        c4 = float(sah_cost_bvh4(wide, pmn, pmx))
        c2 = sah2[("sponza_like", "single_pass")]
        print(
            f"collapse: sah_bvh4 {c4:.2f} (bvh2 {c2:.2f} -> "
            f"improvement {c2/c4:.2f}x; ref claims ~2.2x)",
            file=sys.stderr,
            flush=True,
        )
        check("bvh4_correct", validate.check_bvh4_correctness(wide, n))
        if n == 261996:
            check_sah("sponza_bvh4", c4, SAH_PINS["sponza_like"]["bvh4"])

        # device collapse == CPU oracle at an oracle-sized scene (the CPU
        # collapse is a Python loop); compare only used slots
        b_small = jax.block_until_ready(lbvh.build_single_pass(
            jax.device_put(jnp.asarray(scenes.sponza_like(16_384)), dev)
        ))
        w_dev = jax.block_until_ready(collapse_ops.collapse_bvh2_to_bvh4(b_small))
        w_cpu = collapse_cpu(b_small)
        kk = w_cpu["n_nodes"]
        ok = int(w_dev.n_nodes) == kk
        slots = w_cpu["child"][:kk] >= 0
        for f, mask in [
            ("child", None), ("parent", None), ("child_count", None),
            ("leaf_prim", "full"), ("leaf_parent", "full"),
            ("child_min", "slots"), ("child_max", "slots"),
        ]:
            a = np.asarray(getattr(w_dev, f))
            b = np.asarray(w_cpu[f])
            if mask != "full":
                a, b = a[:kk], b[:kk]
            if mask == "slots":
                a, b = a[slots], b[slots]
            if not np.array_equal(a, b):
                ok = False
                print(f"collapse oracle mismatch in {f}", file=sys.stderr)
        check("collapse_matches_cpu_oracle", ok)

    # batched tiny-mesh throughput (the reference's 4096-mesh demo,
    # main.cpp:39-47; no reference timing published)
    if budget_ok("batched", 180):
        from jax_bvh.models import batched

        n_meshes = 4096
        rng = np.random.default_rng(0)
        meshes = [(rng.normal(size=(32, 3, 3)) * 0.3 + rng.normal(size=(1, 1, 3)))
                  .astype(np.float32) for _ in range(n_meshes)]
        tris_b = jnp.asarray(batched.pad_meshes(meshes, capacity=32)[0])

        def batched_loop(k):
            def body(i, acc):
                t = tris_b * (1.0 + i.astype(jnp.float32) * 3e-7)
                b = batched.build_batched(t)
                return acc + b.packed_t[0, 0, 0] + b.left[0, 0].astype(jnp.float32)

            return lax.fori_loop(0, k, body, 0.0)

        # wide k spread: the per-iteration cost is small against dispatch
        ms = _slope_time(batched_loop, k_lo=4, k_hi=64, reps=5)
        print(
            f"batched: {n_meshes} meshes x32 prims in {ms:.3f} ms "
            f"= {n_meshes/ms*1e3/1e6:.2f} M meshes/s",
            file=sys.stderr,
            flush=True,
        )

    # ---- primary rays on sponza through the raster engine; verified
    # against the wavefront engine with the overflow flag asserted ----
    from jax_bvh.ops import raster, traverse
    from jax_bvh.utils import camera

    bvh = lbvh.build_single_pass(tris)
    tr, cam = scenes.preset("sponza")
    rpack = raster.pack_raster(bvh, tris, leaf_size=64)
    packed = traverse.pack_bvh2(bvh, tris)
    if budget_ok("raster", 420):
        frames = [(512, 512)]
        if not os.environ.get("BVH_BENCH_FAST"):
            frames.append((1920, 1080))  # BASELINE.md's target resolution
        for w, h in frames:
            rays = camera.generate_rays(cam, w, h)

            def raster_loop(k, rays=rays, w=w, h=h):
                def body(i, carry):
                    acc, any_ovf = carry
                    r2 = rays._replace(
                        direction=rays.direction
                        * (1.0 + i.astype(jnp.float32) * 1e-7)
                    )
                    hit, _c, ovf = raster.render_raster(rpack, r2, tr, w, h)
                    return (acc + hit.t[0] + hit.u[1], any_ovf | ovf)

                acc, any_ovf = lax.fori_loop(
                    0, k, body, (0.0, jnp.zeros((), bool))
                )
                return acc + any_ovf.astype(jnp.float32)

            ms, spr = _slope_stats(raster_loop, k_lo=2, k_hi=8, reps=5)
            mrays = (w * h) / (ms * 1e-3) / 1e6
            print(
                f"render(raster): {ms:.3f} ms (±{spr:.0f}%) for {w}x{h} = "
                f"{mrays:.1f} Mrays/s",
                file=sys.stderr,
                flush=True,
            )
            hit_k, _ck, ovf = raster.render_raster(rpack, rays, tr, w, h)
            check(f"raster_{w}x{h}_no_overflow", not bool(ovf))

        # wavefront cross-check at 512^2
        w = h = 512
        rays = camera.generate_rays(cam, w, h)
        hit_k, _ck, ovf = raster.render_raster(rpack, rays, tr, w, h)
        hit_o, _ = traverse.traverse_packed(packed, bvh.n_internal, bvh.root, rays, tr)
        pk = np.asarray(hit_k.prim_idx)
        po = np.asarray(hit_o.prim_idx)
        tk = np.asarray(hit_k.t)
        to = np.asarray(hit_o.t)
        both = pk >= 0
        same_found = np.array_equal(pk >= 0, po >= 0)
        t_match = np.allclose(tk[both], to[both], rtol=1e-4)
        diff = both & (pk != po)
        # differing prims allowed only on t ties
        ties_ok = np.allclose(tk[diff], to[diff], rtol=1e-3) if diff.any() else True
        check("raster_matches_wavefront", same_found and t_match and ties_ok)
        print(
            f"render verify: {int(both.sum())} hits, prim match "
            f"{int((both & (pk == po)).sum())}/{int(both.sum())}, "
            f"overflow={bool(ovf)}",
            file=sys.stderr,
            flush=True,
        )

    # ---- shadow rays (arbitrary origins) from the 1080p primary hits ----
    # The workload the fixed-eye raster cannot serve (reference per-thread
    # kernels: TraversalKernel.h:337-451): origins on the primary-hit
    # surfaces, direction to a point light, finite tmax. The full engine is
    # timed — coherence sort, binning and the sweep — and verified against
    # the wavefront oracle under the same tmax cap.
    if budget_ok("shadow_rays", 420):
        from jax_bvh.ops import ray_sweep
        from jax_bvh.types import Rays as _Rays

        tb = tris.reshape(-1, 3)
        smin3 = np.asarray(jnp.min(tb, axis=0))
        smax3 = np.asarray(jnp.max(tb, axis=0))
        diag = float(np.linalg.norm(smax3 - smin3))
        light = jnp.array(
            [(smin3[0] + smax3[0]) * 0.5, smax3[1] + 0.1 * diag,
             (smin3[2] + smax3[2]) * 0.5],
            jnp.float32,
        )
        eps = 1e-3 * diag
        # rays only from primary-hit surfaces (a renderer never shadows a
        # miss pixel), compacted host-side to the live set
        wf2, hf2 = 1920, 1080
        rays_sf = camera.generate_rays(cam, wf2, hf2)
        hit_f, _cf, ovf_sf = raster.render_raster(rpack, rays_sf, tr, wf2, hf2)
        check("shadow_primary_no_overflow", not bool(ovf_sf))
        sel = jnp.asarray(np.nonzero(np.asarray(hit_f.prim_idx) >= 0)[0], jnp.int32)
        n_shadow = int(sel.shape[0])
        so = rays_sf.origin[sel] + rays_sf.direction[sel] * hit_f.t[sel][:, None]
        dvec = light[None, :] - so
        dist = jnp.linalg.norm(dvec, axis=1)
        dl = dvec / jnp.maximum(dist, 1e-9)[:, None]
        srays = _Rays(
            origin=so + dl * eps,
            direction=dl,
            tmin=jnp.zeros_like(dist),
            tmax=dist - 2 * eps,
        )
        live = jnp.ones((n_shadow,), bool)

        # the general (closest-hit) row runs on a 64K strided slice (a
        # prefix once sampled no occluded rays at all)
        nv = min(65536, n_shadow)
        vsel = jnp.asarray(np.linspace(0, n_shadow - 1, nv).astype(np.int32))
        srays_v = _Rays(*(f[vsel] for f in srays))

        def shadow_loop(k):
            def body(i, carry):
                acc, any_ovf = carry
                r2 = srays_v._replace(
                    origin=srays_v.origin * (1.0 + i.astype(jnp.float32) * 3e-7)
                )
                hit, _c, ovf = ray_sweep.trace_rays(rpack, r2, tr, cand_cap=4096)
                return (acc + hit.t[0] + hit.u[1], any_ovf | ovf)

            acc, any_ovf = lax.fori_loop(
                0, k, body, (0.0, jnp.zeros((), bool))
            )
            return acc + any_ovf.astype(jnp.float32)

        ms_s, spr_s = _slope_stats(shadow_loop, k_lo=1, k_hi=4, reps=5)
        print(
            f"shadow rays(general sweep): {ms_s:.3f} ms (±{spr_s:.0f}%) "
            f"for {nv} surface-origin rays = {nv / (ms_s * 1e-3) / 1e6:.1f} Mrays/s",
            file=sys.stderr,
            flush=True,
        )

        # reversed path: pinhole-at-the-light occlusion query over every
        # live ray (same world segments, boolean answer identical)
        def shadow_rev_loop(k):
            def body(i, carry):
                acc, any_ovf = carry
                occ, _c, ovf = ray_sweep.shadow_occlusion(
                    rpack, so * (1.0 + i.astype(jnp.float32) * 3e-7),
                    live, light, tr, float(eps), cand_cap=4096,
                )
                return (acc + jnp.sum(occ.astype(jnp.float32)), any_ovf | ovf)

            acc, any_ovf = lax.fori_loop(
                0, k, body, (0.0, jnp.zeros((), bool))
            )
            return acc + any_ovf.astype(jnp.float32)

        ms_r, spr_r = _slope_stats(shadow_rev_loop, k_lo=1, k_hi=4, reps=5)
        print(
            f"shadow occlusion(reversed): {ms_r:.3f} ms (±{spr_r:.0f}%) "
            f"for {n_shadow} live rays = {n_shadow / (ms_r * 1e-3) / 1e6:.1f} Mrays/s",
            file=sys.stderr,
            flush=True,
        )
        occ_r, _cr, ovf_r = ray_sweep.shadow_occlusion(
            rpack, so, live, light, tr, float(eps), cand_cap=4096,
        )
        check("shadow_rev_no_overflow", not bool(ovf_r))

        # oracle verify (the wavefront engine ignores tmax: cap its answer)
        # on the same 64K slice
        hit_s, _cs, ovf_s = ray_sweep.trace_rays(rpack, srays_v, tr, cand_cap=4096)
        check("shadow_no_overflow", not bool(ovf_s))
        hit_so, _ = traverse.traverse_packed(
            packed, bvh.n_internal, bvh.root, srays_v, tr
        )
        ps = np.asarray(hit_s.prim_idx)
        ts = np.asarray(hit_s.t)
        po2 = np.asarray(hit_so.prim_idx)
        to2 = np.asarray(hit_so.t)
        tmax_np = np.asarray(srays_v.tmax)
        occ = (po2 >= 0) & (to2 < tmax_np)
        # strict mask equality except inside the float-noise boundary
        # strips at t ~ 0 (grazing the origin surface) and t ~ tmax
        to_safe = np.where(po2 >= 0, to2, np.inf)
        boundary = (np.abs(to_safe - tmax_np) < 10 * eps) | (
            to_safe < 10 * eps
        )
        same_found = not (((ps >= 0) != occ) & ~boundary).any()
        both_s = (ps >= 0) & occ
        t_ok = np.allclose(ts[both_s], to2[both_s], rtol=1e-3, atol=1e-3)
        dmask = both_s & (ps != po2)
        ties_ok = (
            np.allclose(ts[dmask], to2[dmask], rtol=1e-3, atol=1e-3)
            if dmask.any() else True
        )
        check("shadow_matches_wavefront", same_found and t_ok and ties_ok)
        occ_rev = np.asarray(occ_r)[np.asarray(vsel)]
        rev_ok = not ((occ_rev != occ) & ~boundary).any()
        check("shadow_rev_matches_wavefront", rev_ok)
        print(
            f"shadow verify: {int(both_s.sum())} occluded, prim match "
            f"{int((both_s & (ps == po2)).sum())}/{int(both_s.sum())}, "
            f"overflow={bool(ovf_s)}; reversed mask "
            f"{int((occ_rev == occ).sum())}/{occ.shape[0]} "
            f"overflow={bool(ovf_r)}",
            file=sys.stderr,
            flush=True,
        )

    # wavefront row (the general engine, 512^2 primary rays)
    if budget_ok("wavefront", 180):
        w = h = 512
        rays = camera.generate_rays(cam, w, h)
        ni = bvh.n_internal
        root = bvh.root

        def wavefront_loop(k):
            def body(i, acc):
                r2 = rays._replace(
                    origin=rays.origin * (1.0 + i.astype(jnp.float32) * 3e-7)
                )
                hit, _ = traverse.traverse_packed(packed, ni, root, r2, tr)
                return acc + hit.t[0]

            return lax.fori_loop(0, k, body, 0.0)

        ms = _slope_time(wavefront_loop, k_lo=1, k_hi=4, reps=3)
        mrays = (w * h) / (ms * 1e-3) / 1e6
        print(
            f"traversal(packed wavefront): {ms:.3f} ms = {mrays:.1f} Mrays/s",
            file=sys.stderr,
            flush=True,
        )

    verified = all(ok for _, ok in CHECKS) and bool(CHECKS)
    n_fail = sum(1 for _, ok in CHECKS if not ok)
    print(
        f"verification: {len(CHECKS) - n_fail}/{len(CHECKS)} checks passed"
        f" (all sections){'' if verified else ' — FAILURES ABOVE'}",
        file=sys.stderr,
        flush=True,
    )
    print(
        f"wall clock: {time.monotonic() - T0:.0f}s of {BUDGET_S:.0f}s budget",
        file=sys.stderr,
        flush=True,
    )
    if not verified:
        sys.exit(1)


if __name__ == "__main__":
    main()
