#!/usr/bin/env python
"""Headline benchmark: conference primary-ray Mrays/s on the current device.

Prints ONE JSON line {"metric", "value", "unit", ...}; per-stage details go
to stderr. The frame is the full 1024x768 primary batch traced through
Renderer.trace_primary (the path render() runs); the value is rays over the
best of several block_until_ready walls of that trace stage alone, after a
warm-up call (`trace_ms`; raygen, shading and readback are not in it). A stride
sample of the frame is checked against the CPU golden tracer with the
tie-aware rule of trace/cpu.py golden_mismatches.

Scene provenance: the real Conference OBJ is not available offline, so the
procedural conference stand-in (~280k triangles, interior workload
character) is used -- see ntrace_tpu/scenes/procedural.py.

  python bench.py          (env: NTRACE_BENCH_TRIS / _W / _H / _ENGINE /
                            _BUILDER / _REPS / _GOLDEN_RAYS)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ntrace_tpu.core import BuildConfig, RenderConfig
    from ntrace_tpu.device import card_name_and_power_limit, enable_compile_cache
    from ntrace_tpu.ray import pixel_table, raygen
    from ntrace_tpu.render.renderer import Renderer, build_accel
    from ntrace_tpu.scenes import default_camera, get_scene
    from ntrace_tpu.trace.cpu import golden_mismatches, trace_cpu_golden

    enable_compile_cache()
    t0 = time.time()
    n_tris = int(os.environ.get("NTRACE_BENCH_TRIS", 280_000))
    width = int(os.environ.get("NTRACE_BENCH_W", 1024))
    height = int(os.environ.get("NTRACE_BENCH_H", 768))
    engine = os.environ.get("NTRACE_BENCH_ENGINE", "auto")
    builder = os.environ.get("NTRACE_BENCH_BUILDER", "binned_sah")
    reps = int(os.environ.get("NTRACE_BENCH_REPS", 5))

    dev = jax.devices()[0]
    card = (card_name_and_power_limit() if dev.platform == "gpu"
            else "no GPU")
    print(f"[bench] platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} card={card}", file=sys.stderr)
    scene = get_scene("conference", n_tris=n_tris)
    build_cfg = BuildConfig(builder=builder)
    flat = build_accel(scene, build_cfg, use_cache=True)
    print(f"[bench] scene={scene.name} tris={scene.num_tris} "
          f"nodes={flat.nodes.shape[0]} ({time.time()-t0:.1f}s)",
          file=sys.stderr)

    cfg = RenderConfig(width=width, height=height, mode="primary",
                       engine=engine)
    r = Renderer(scene, build_cfg, cfg, flat=flat)
    ca = raygen.camera_arrays(default_camera("conference"), width, height)
    order_px, _ = pixel_table(width, height)
    batch = raygen.primary(ca, width, height, jnp.asarray(order_px))
    args = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
    R = batch.num_rays

    tri, t, _, _ = jax.block_until_ready(r.trace_primary(*args))  # warm-up
    walls = []
    for _ in range(reps):
        t1 = time.perf_counter()
        jax.block_until_ready(r.trace_primary(*args))
        walls.append(time.perf_counter() - t1)
    best = min(walls)
    mrays = R / 1e6 / best
    print(f"[bench] engine={r.engine} walls ms="
          f"{[round(w * 1e3, 3) for w in walls]}", file=sys.stderr)

    n_sub = int(os.environ.get("NTRACE_BENCH_GOLDEN_RAYS", 4096))
    sub = np.arange(0, R, max(R // n_sub, 1))
    rec = trace_cpu_golden(flat, *(np.asarray(a)[sub] for a in args))
    dev_tri = np.asarray(tri)[sub]
    raw = int((dev_tri != rec.tri).sum())
    mism = golden_mismatches(dev_tri, np.asarray(t)[sub], rec.tri, rec.t)
    print(json.dumps({
        "metric": "conference_primary_mrays",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "trace_ms": round(best * 1e3, 3),
        "engine": r.engine,
        "hit_rate": round(float((np.asarray(tri) >= 0).mean()), 4),
        "golden_sampled": int(len(sub)),
        "golden_raw_mismatches": raw,
        "golden_mismatches": mism,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
