#!/usr/bin/env python
"""Benchmark matrix over the CONFIGS below -> results/matrix.json
(NTRACE_MATRIX_OUT overrides the file name under results/).

Per config and mode:
  mrays_<mode>        -- chained-marginal Mrays/s (K=1 vs K traces inside
                         one jit, serialized via tmin).
  mrays_wall_<mode>   -- render() wall flavor, best of 2.
  build_marginal_ms_per_mtri -- device LBVH rebuild (chained
                         scalar-consuming jit of the flat emission the
                         renderer uses, compile excluded).
  golden_mismatches   -- device primary hits vs the CPU golden tracer,
                         tie-aware (trace/cpu.py golden_mismatches); scenes
                         whose golden would take > ~10 min use a 65,536-ray
                         stride sample (golden_sampled).

Run one process per card.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import jax.numpy as jnp
import numpy as np

from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.render.renderer import Renderer, build_accel
from ntrace_tpu.scenes import default_camera, get_scene

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "results", os.environ.get("NTRACE_MATRIX_OUT",
                                             "matrix.json"))
K = int(os.environ.get("NTRACE_MATRIX_CHAIN", 4))

CONFIGS = [
    # (scene, n_tris, builder, bcfg_extra, modes, samples)
    ("sibenik",    80_000,   "binned_sah",
     dict(sah_tri_cost=0.02, max_leaf_size=48), ["primary"], 4),
    ("conference", 280_000,  "lbvh",
     dict(max_leaf_size=32, sah_tri_cost=0.02), ["primary", "shadow"], 4),
    ("fairy",      170_000,  "hlbvh",
     dict(max_leaf_size=32, sah_tri_cost=0.02), ["diffuse", "ao"], 4),
    ("hairball",   2_900_000, "lbvh",
     dict(max_leaf_size=32, sah_tri_cost=0.02), ["ao"], 4),
    ("san_miguel", 10_000_000, "sbvh",
     dict(sah_tri_cost=0.02, max_leaf_size=48), ["path"], 1),
    ("conference", 280_000,  "kdtree",
     dict(max_leaf_size=16, sah_tri_cost=0.5), ["primary"], 4),
    # Supplementary: tree-quality A/B for incoherent rays (the row above
    # keeps HLBVH per BASELINE's prescribed build path).
    ("fairy",      170_000,  "binned_sah",
     dict(max_leaf_size=32, sah_tri_cost=0.02), ["diffuse"], 4),
]

results = []


def flush():
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)


def marginal_mrays(make_run, nrays, args):
    """Chained-marginal Mrays/s (bench.py protocol): K=1 vs K jit chains,
    best-of-3 walls each; returns (mrays, marginal_ms, wall1_ms)."""
    walls = {}
    for k in (1, K):
        run = make_run(k)
        jax.block_until_ready(run(*args))
        best = 1e30
        for _ in range(3):
            t0 = time.time()
            jax.block_until_ready(run(*args))
            best = min(best, time.time() - t0)
        walls[k] = best
    marg = (walls[K] - walls[1]) / (K - 1)
    return nrays / 1e6 / marg, marg * 1e3, walls[1] * 1e3


def lbvh_build_marginal(scene, ml):
    """Chained-marginal device rebuild, all outputs consumed (the flat
    emission build_lbvh_flat runs for the renderer's per-frame rebuild)."""
    from ntrace_tpu.bvh.lbvh import lbvh_device_fast

    tv = scene.tri_verts()
    args = (jnp.asarray(tv.min(axis=1)), jnp.asarray(tv.max(axis=1)),
            jnp.asarray(tv), *map(jnp.asarray, scene.bbox()))

    def chain(k):
        @jax.jit
        def run(tlo, thi, tvd, lo, hi):
            def body(i, acc):
                out = lbvh_device_fast(
                    tlo + acc * 1e-30, thi, tvd, lo, hi, max_leaf=ml)
                return (acc + out["nodes"][0].sum() * 1e-9
                        + out["woop"][0].sum() * 1e-9
                        + out["node_count"].astype(jnp.float32) * 1e-9)
            return jax.lax.fori_loop(0, k, body, jnp.float32(0.0))
        return run

    walls = {}
    for k in (1, 5):
        run = chain(k)
        float(jax.block_until_ready(run(*args)))
        best = 1e30
        for _ in range(2):
            t0 = time.time()
            float(jax.block_until_ready(run(*args)))
            best = min(best, time.time() - t0)
        walls[k] = best
    return (walls[5] - walls[1]) / 4 * 1e3


_only = os.environ.get("NTRACE_MATRIX_ONLY")
for name, n, builder, extra, modes, samples in CONFIGS:
    if _only and name not in _only.split(","):
        continue
    try:
        t0 = time.time()
        scene = get_scene(name, n_tris=n)
        print(f"[{name}] gen {time.time()-t0:.0f}s tris={scene.num_tris}",
              flush=True)
        bcfg = BuildConfig(builder=builder, **extra)
        t0 = time.time()
        flat = build_accel(scene, bcfg, use_cache=True)
        bt = time.time() - t0
        build_rec = {}
        if builder in ("lbvh", "hlbvh"):
            # Warmup uncached build first, so the timed call excludes the
            # XLA compile.
            t0 = time.time()
            build_accel(scene, bcfg, use_cache=False)
            warm0 = time.time() - t0
            t0 = time.time()
            flat = build_accel(scene, bcfg, use_cache=False)
            bt = time.time() - t0
            build_rec["build_warmup_s"] = round(warm0, 1)
            if builder == "lbvh":
                try:
                    bm = lbvh_build_marginal(scene, extra["max_leaf_size"])
                    build_rec["build_marginal_ms"] = round(bm, 1)
                    build_rec["build_marginal_ms_per_mtri"] = round(
                        bm / (scene.num_tris / 1e6), 1)
                except Exception as e:
                    build_rec["build_marginal_error"] = str(e)[:200]
        print(f"[{name}] {builder} build {bt:.1f}s "
              f"nodes={getattr(flat, 'nodes', np.zeros((0,))).shape[0]} "
              f"{build_rec}", flush=True)
        cfg = RenderConfig(width=1024, height=768, mode=modes[0],
                           samples=samples)
        r = Renderer(scene, bcfg, cfg, flat=flat)
        cam = default_camera(name)

        # Shared primary batch (raygen is off the clock in both flavors).
        from ntrace_tpu.ray import pixel_table, raygen

        W, H = 1024, 768
        ca = raygen.camera_arrays(cam, W, H)
        order_px, _ = pixel_table(W, H)
        batch = raygen.primary(ca, W, H, jnp.asarray(order_px))

        def chained_primary(k):
            # fori_loop: the loop body is traced once; the tn2/acc carry
            # serializes the K traces.
            @jax.jit
            def run(o, d, tn, tx):
                def body(_, c):
                    acc, tn2 = c
                    tri, t, u, v = r.trace_primary(o, d, tn2, tx)
                    acc = acc + jnp.where(tri >= 0, t, 0.0).sum()
                    return acc, tn + 1e-12 * acc
                acc, _ = jax.lax.fori_loop(
                    0, k, body, (jnp.float32(0), tn))
                return acc
            return run

        pargs = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
        prim_mrays, prim_ms, prim_wall1 = marginal_mrays(
            chained_primary, batch.num_rays, pargs)
        print(f"[{name}] primary marginal {prim_ms:.1f} ms "
              f"({prim_mrays:.1f} Mrays/s)", flush=True)

        # Primary hits once (also feeds secondary raygen + golden).
        tri0, t0_, u0, v0 = r.trace_primary(
            batch.orig, batch.dirn, batch.tmin, batch.tmax)
        jax.block_until_ready(t0_)

        for mode in modes:
            entry = dict(scene=name, tris=scene.num_tris, builder=builder,
                         mode=mode, engine=r.engine, build_s=round(bt, 1),
                         build_ms_per_mtri=round(
                             bt * 1e3 / (scene.num_tris / 1e6), 1),
                         **build_rec,
                         mrays_primary=round(prim_mrays, 2),
                         marginal_primary_ms=round(prim_ms, 2))
            if mode in ("shadow", "ao", "diffuse"):
                sec, any_hit = r.gen_secondary(cam, mode, batch, tri0, t0_)
                jax.block_until_ready(sec.tmax)
                # The tracer render() actually uses for this mode:
                # subset-seeded for long incoherent closest-hit bounces
                # (seed pass runs INSIDE the chain -- honest marginal).
                def chained_sec(k):
                    @jax.jit
                    def run(o, d, tn, tx):
                        sec_tracer = r._secondary_tracer(
                            long_rays=(mode == "diffuse"))

                        def body(_, c):
                            acc, tn2 = c
                            stri, st, su, sv = sec_tracer(
                                o, d, tn2, tx, any_hit)
                            acc = acc + jnp.where(
                                st < 3e37, st, 0.0).sum()
                            return acc, tn + 1e-12 * acc
                        acc, _ = jax.lax.fori_loop(
                            0, k, body, (jnp.float32(0), tn))
                        return acc
                    return run

                sargs = (sec.orig, sec.dirn, sec.tmin, sec.tmax)
                m, ms, w1 = marginal_mrays(chained_sec, sec.num_rays, sargs)
                entry[f"mrays_{mode}"] = round(m, 2)
                entry[f"marginal_{mode}_ms"] = round(ms, 2)
                print(f"[{name}] {mode} marginal {ms:.1f} ms "
                      f"({m:.1f} Mrays/s)", flush=True)
            # Wall flavor: the old render()-stats numbers, best of 2.
            best = {}
            for i in range(2):
                res = r.render(cam, mode=mode)
                for k2, v in res.stats.items():
                    if k2.startswith("mrays"):
                        best[k2] = max(best.get(k2, 0), v)
            entry.update({f"mrays_wall_{k2[6:]}": round(v, 3)
                          for k2, v in best.items()})
            results.append(entry)
            print(f"[{name}] {mode}: {entry}", flush=True)
            flush()

        # ---- Full-frame device golden (tie-aware) --------------------
        try:
            from ntrace_tpu.trace.cpu import (golden_mismatches,
                                              trace_cpu_golden)

            gflat = r.flat
            o = np.asarray(batch.orig)
            d = np.asarray(batch.dirn)
            tn = np.asarray(batch.tmin)
            tx = np.asarray(batch.tmax)
            t0 = time.time()
            probe = trace_cpu_golden(gflat, o[:4096], d[:4096],
                                     tn[:4096], tx[:4096])
            est = (time.time() - t0) * batch.num_rays / 4096
            if est > 600:
                sub = np.arange(0, batch.num_rays,
                                max(batch.num_rays // 65536, 1))
            else:
                sub = np.arange(batch.num_rays)
            rec = trace_cpu_golden(gflat, o[sub], d[sub], tn[sub], tx[sub])
            tri_dev = np.asarray(tri0)[sub]
            t_dev = np.asarray(t0_)[sub]
            mism = golden_mismatches(tri_dev, t_dev, rec.tri, rec.t)
            results.append(dict(scene=name, builder=builder,
                                golden_sampled=int(len(sub)),
                                golden_mismatches=mism,
                                golden_match=mism == 0,
                                golden_full=bool(len(sub)
                                                 == batch.num_rays)))
            print(f"[{name}] golden: {mism}/{len(sub)} mismatches "
                  f"(full={len(sub) == batch.num_rays})", flush=True)
        except Exception as e:
            results.append(dict(scene=name, builder=builder,
                                golden_error=str(e)[:200]))
            print(f"[{name}] golden FAILED: {str(e)[:200]}", flush=True)
        flush()
    except Exception as e:
        print(f"[{name}] FAILED: {type(e).__name__}: {str(e)[:300]}",
              flush=True)
        results.append(dict(scene=name, error=str(e)[:300]))
        flush()
print("MATRIX DONE", flush=True)
