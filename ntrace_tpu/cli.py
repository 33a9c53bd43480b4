"""Command-line interface: benchmark mode + single-frame render.

Reference parity (~ rt/App.cpp benchmark mode, SURVEY.md SS3.2): the
reference app runs `benchmark --mesh=... --camera=<sig> --kernel=...
--mode=... --sbvh-alpha=... --ao-radius=... --samples=... --sort=...
--warmup-repeats=N --measure-repeats=N --log=file` over a matrix of
cameras x kernels x modes and logs Mrays/s per ray type. This CLI keeps
those flag semantics, adds --builder/--width/--height, and writes
structured JSON results (SURVEY.md SS6.5) next to the text log.

Scenes: --mesh accepts an .obj path or a procedural scene name
("conference", "sibenik@50000", ...). Cameras: --camera takes our
signature strings (core.Camera codec) or "default".

Examples:
  python -m ntrace_tpu.cli benchmark --mesh=conference --mode=primary,diffuse
  python -m ntrace_tpu.cli render --mesh=sibenik@20000 --out=frame.png
  python -m ntrace_tpu.cli benchmark --mesh=scenes/conf.obj \
      --camera=<sig> --kernel=fermi_speculative_while_while --mode=ao
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np


def _load_scene(mesh: str):
    from ntrace_tpu.io.obj import load_scene_cached
    from ntrace_tpu.scenes import SCENE_REGISTRY, get_scene

    if mesh.endswith(".obj") or os.path.sep in mesh or os.path.exists(mesh):
        return load_scene_cached(mesh)
    base = mesh.split("@")[0]
    if base in SCENE_REGISTRY:
        return get_scene(mesh)
    raise SystemExit(f"unknown mesh {mesh!r}: not a file, not in "
                     f"{sorted(SCENE_REGISTRY)}")


def _resolve_camera(spec: str, scene_name: str):
    from ntrace_tpu.core import Camera
    from ntrace_tpu.scenes import default_camera

    if spec in ("default", ""):
        return default_camera(scene_name)
    return Camera.decode_signature(spec)


def _common_flags(p: argparse.ArgumentParser):
    p.add_argument("--mesh", required=True,
                   help=".obj path or procedural scene name (name[@ntris])")
    p.add_argument("--camera", action="append", default=None,
                   help="camera signature or 'default'; repeat for a matrix")
    p.add_argument("--kernel", default="auto",
                   help="kernel/engine name (reference names accepted)")
    p.add_argument("--builder", default="median",
                   choices=["median", "binned_sah", "sbvh", "lbvh", "hlbvh", "kdtree"])
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--samples", type=int, default=4,
                   help="AO/diffuse rays per hit (numSamples)")
    p.add_argument("--ao-radius", type=float, default=1.0, dest="ao_radius")
    p.add_argument("--no-sort", action="store_true",
                   help="disable Morton re-sort of secondary rays")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache", action="store_true",
                   help="use the on-disk accel cache")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the measured passes")


def _make_renderer(args, mode: str):
    from ntrace_tpu.core import BuildConfig, RenderConfig
    from ntrace_tpu.render.renderer import Renderer, build_accel
    from ntrace_tpu.trace.registry import resolve_kernel

    spec = resolve_kernel(args.kernel)
    scene = _load_scene(args.mesh)
    build_cfg = BuildConfig(builder=args.builder)
    flat = build_accel(scene, build_cfg, use_cache=args.cache)
    cfg = RenderConfig(
        width=args.width, height=args.height, mode=mode,
        engine=spec.engine, kernel=args.kernel, samples=args.samples,
        ao_radius=args.ao_radius, sort_secondary=not args.no_sort,
        seed=args.seed,
    )
    return scene, Renderer(scene, build_cfg, cfg, flat=flat), flat


def cmd_benchmark(args) -> int:
    if args.measure_repeats < 1:
        print("benchmark: --measure-repeats must be >= 1", file=sys.stderr)
        return 2
    modes = args.mode.split(",")
    cameras = args.camera if isinstance(args.camera, list) else [args.camera]
    scene, renderer, flat = _make_renderer(args, modes[0])
    results = []
    log_lines = []

    for cam_spec in cameras:
        cam = _resolve_camera(cam_spec, scene.name)
        for mode in modes:
            per_pass = []
            total = args.warmup_repeats + args.measure_repeats
            prof = None
            for i in range(total):
                if args.profile and i == args.warmup_repeats:
                    import jax

                    prof = jax.profiler.trace(args.profile)
                    prof.__enter__()
                res = renderer.render(cam, mode=mode)
                if i >= args.warmup_repeats:
                    per_pass.append(res.stats)
            if prof is not None:
                prof.__exit__(None, None, None)
            # Reference convention: best measured pass, kernel time only.
            def best(key):
                vals = [p[key] for p in per_pass if key in p]
                return max(vals) if vals else None

            mrays = {k: best(k) for k in per_pass[-1] if k.startswith("mrays")}
            entry = {
                "scene": scene.name,
                "tris": scene.num_tris,
                "camera": cam.encode_signature(),
                "kernel": args.kernel,
                "builder": args.builder,
                "mode": mode,
                "width": args.width,
                "height": args.height,
                "samples": args.samples,
                "accel_nodes": int(flat.nodes.shape[0]),
                "accel_sah": round(float(flat.sah_cost), 3),
                "accel_mbytes": round(flat.nbytes() / 1e6, 2),
                "stats_ms": {k: round(v, 3) for k, v in per_pass[-1].items()
                             if not k.startswith("mrays")},
                **{k: round(v, 4) for k, v in mrays.items() if v},
            }
            results.append(entry)
            line = (f"{scene.name:12s} {mode:8s} {args.kernel:32s} "
                    + " ".join(f"{k.replace('mrays_', '')}={v:.3f}Mr/s"
                               for k, v in mrays.items() if v))
            log_lines.append(line)
            print(line)

    out_dir = Path(args.results_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    out = out_dir / f"bench_{scene.name}_{stamp}.json"
    out.write_text(json.dumps(results, indent=2))
    print(f"results -> {out}", file=sys.stderr)
    if args.log:
        Path(args.log).write_text("\n".join(log_lines) + "\n")
    return 0


def cmd_render(args) -> int:
    from ntrace_tpu.io.image import write_png

    scene, renderer, _ = _make_renderer(args, args.mode)
    cam = _resolve_camera(args.camera[0], scene.name)
    res = renderer.render(cam)
    write_png(args.out, res.image)
    hit_rate = float((res.hit_tri >= 0).mean())
    print(f"{args.out}: {args.width}x{args.height} {args.mode} "
          f"hit_rate={hit_rate:.3f} "
          f"stats={ {k: round(v, 2) for k, v in res.stats.items()} }")
    return 0


def cmd_info(args) -> int:
    from ntrace_tpu.scenes import SCENE_REGISTRY
    from ntrace_tpu.trace.registry import kernel_names

    print("scenes: ", ", ".join(sorted(SCENE_REGISTRY)))
    print("kernels:", ", ".join(kernel_names()))
    print("builders: median, binned_sah, sbvh, lbvh, hlbvh")
    print("modes:   primary, shadow, ao, diffuse, path, textured")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ntrace_tpu",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)

    b = sub.add_parser("benchmark", help="scripted benchmark mode")
    _common_flags(b)
    b.add_argument("--mode", default="primary",
                   help="comma list: primary,shadow,ao,diffuse,path,textured")
    b.add_argument("--warmup-repeats", type=int, default=1, dest="warmup_repeats")
    b.add_argument("--measure-repeats", type=int, default=2, dest="measure_repeats")
    b.add_argument("--log", default=None, help="text log file")
    b.add_argument("--results-dir", default="results", dest="results_dir")
    b.set_defaults(fn=cmd_benchmark)

    r = sub.add_parser("render", help="render one frame to PNG")
    _common_flags(r)
    r.add_argument("--mode", default="primary")
    r.add_argument("--out", default="frame.png")
    r.set_defaults(fn=cmd_render)

    i = sub.add_parser("info", help="list scenes/kernels/builders")
    i.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    if getattr(args, "cpu", False):
        import jax

        jax.config.update("jax_platforms", "cpu")
    from ntrace_tpu.device import enable_compile_cache

    enable_compile_cache()
    # --camera may be given multiple times for a benchmark matrix.
    if hasattr(args, "camera") and not args.camera:
        args.camera = ["default"]
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
