#!/usr/bin/env python
"""Smoke run of the renderer's main path on one NVIDIA GPU, at full size.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --cards 4    # four cards: the ray data-parallel
                                      # tier only, against one device

Phases (one process, one card, the entry points a user calls):
  1. device   : fail unless JAX's first device is a GPU; print its kind,
                the device count, the nvidia-smi name and power limit, and
                the JAX version.
  2. main     : the conference stand-in at its full ~280k triangles,
                binned-SAH build (accel cache on), Renderer.render at
                1024x768 with engine="auto" for primary, shadow and AO.
  3. lbvh     : the per-frame device LBVH build of the same scene
                (build_lbvh_flat), then primary rays traced through it.
  4. golden   : a 65,536-ray stride sample of render's own hits on every
                pass of phases 2-3 against the CPU golden tracer
                (trace/cpu.py).
  5. kernel   : the ww kernel against stack2 through Renderer.render on
                the full primary and AO frames: hit agreement and walls.

Walls printed here are informational, not a benchmark. The last line of
standard output is one JSON object; any failed phase raises, so the
process exits non-zero and prints no such line.

Golden rule (phases 3-4). Closest hit: a device id that differs from the
golden's counts as a mismatch unless both distances agree within 4 f32
ulps (trace/cpu.py golden_mismatches: rays on a shared mesh edge hit two
triangles at one point). Any hit: the occluded flag must agree. Every
remaining residue is classified by the margin that decided it:
  barycentric : the hit's u, v or 1-u-v lies within BARY_EPS of an edge;
  distance    : both hit, t differs by more than 4 ulps but within
                DIST_EPS relative (the two ids' t values cross);
  interval    : the hit's t lies within DIST_EPS of the ray's tmin/tmax;
  slab        : a box on the path to the hit leaf has its entry/exit
                span within SLAB_EPS of empty;
  unexplained : none of these -- always a failure.
ALLOWANCE: the GPU compiler may contract a*b+c into one FMA where the
numpy golden rounds twice, so a decision whose deciding quantity lies
within a few ulps of its boundary can flip. At most MAX_CLASSIFIED_FRAC
of a pass's sample may be such classified residues.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ntrace_tpu.core import BuildConfig, RenderConfig  # noqa: E402
from ntrace_tpu.device import (  # noqa: E402
    card_name_and_power_limit, enable_compile_cache)
from ntrace_tpu.ops.aabb import safe_inv_dir  # noqa: E402
from ntrace_tpu.ray import pixel_table, raygen  # noqa: E402
from ntrace_tpu.render.renderer import Renderer, build_accel  # noqa: E402
from ntrace_tpu.scenes import default_camera, get_scene  # noqa: E402
from ntrace_tpu.trace.cpu import golden_mismatches, trace_cpu_golden  # noqa: E402

W, H = 1024, 768
GOLDEN_RAYS = 65_536
BARY_EPS = 2.0 ** -20      # ~8 f32 ulps of 1.0
DIST_EPS = 2.0 ** -20      # relative
SLAB_EPS = 2.0 ** -20      # relative to the span's scale
MAX_CLASSIFIED_FRAC = 1e-4  # of a pass's sample (6 of 65,536)


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    """A phase check that holds under python -O too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def best_wall(fn, reps=3):
    """Warm-up call, then the best of `reps` walls; returns (out, s)."""
    out = fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        walls.append(time.perf_counter() - t0)
    return out, min(walls)


# ---------------------------------------------------------------- golden

class Classifier:
    """Explains golden residues by the margin that decided them (f64
    re-evaluation of the stored f32 Woop rows and node boxes)."""

    def __init__(self, flat):
        self.flat = flat
        ti = flat.tri_index
        real = np.nonzero(ti >= 0)[0]
        self.row_of = np.zeros(int(ti.max()) + 1, np.int64)
        self.row_of[ti[real]] = real
        self.sent = np.nonzero(ti < 0)[0]
        enc = np.ascontiguousarray(flat.nodes[:, 12:14]).view(np.int32)
        n = flat.nodes.shape[0]
        self.parent = np.full(n, -1, np.int64)
        self.leaf_parent = {}
        for k in range(2):
            inner = enc[:, k] >= 0
            self.parent[enc[inner, k]] = np.nonzero(inner)[0]
            for i in np.nonzero(~inner)[0]:
                self.leaf_parent[int(~enc[i, k])] = int(i)

    def woop(self, tri, o, d):
        w = self.flat.woop[self.row_of[tri]].astype(np.float64)
        o = o.astype(np.float64)
        d = d.astype(np.float64)
        t = (w[3] - o @ w[0:3]) / (d @ w[0:3])
        u = w[7] + o @ w[4:7] + t * (d @ w[4:7])
        v = w[11] + o @ w[8:11] + t * (d @ w[8:11])
        return t, u, v

    def slab_margin(self, tri, o, d, tn, tx):
        """Smallest relative entry/exit gap of the boxes on the path from
        the root to the leaf holding `tri`, for the segment [tn, tx]."""
        row = self.row_of[tri]
        k = np.searchsorted(self.sent, row)
        start = int(self.sent[k - 1] + 1) if k > 0 else 0
        node = self.leaf_parent[start]
        inv = safe_inv_dir(np, d[None, :])[0].astype(np.float64)
        o = o.astype(np.float64)
        nd = self.flat.nodes.astype(np.float64)
        worst, child_is = np.inf, ("leaf", start)
        while node >= 0:
            rec = nd[node]
            enc = np.ascontiguousarray(
                self.flat.nodes[node, 12:14]).view(np.int32)
            side = 0 if ((child_is[0] == "leaf" and enc[0] == ~child_is[1])
                         or (child_is[0] == "node"
                             and enc[0] == child_is[1])) else 1
            idx = [(0, 1), (2, 3), (8, 9)] if side == 0 else \
                [(4, 5), (6, 7), (10, 11)]
            t0 = [(rec[a] - o[j]) * inv[j] for j, (a, _) in enumerate(idx)]
            t1 = [(rec[b] - o[j]) * inv[j] for j, (_, b) in enumerate(idx)]
            begin = max(max(min(a, b) for a, b in zip(t0, t1)), tn)
            end = min(min(max(a, b) for a, b in zip(t0, t1)), tx)
            worst = min(worst, (end - begin) / max(abs(end), abs(begin), 1e-30))
            child_is = ("node", node)
            node = int(self.parent[node])
        return worst

    def classify(self, tri, o, d, tn, tx, other_t):
        """Margin class of one ray's hit on `tri` (found by one side only
        or with a different id on the other side)."""
        t, u, v = self.woop(tri, o, d)
        if min(u, v, 1.0 - u - v) <= BARY_EPS:
            return "barycentric"
        if np.isfinite(other_t) and abs(t - other_t) <= DIST_EPS * abs(t):
            return "distance"
        if min(t - tn, tx - t) <= DIST_EPS * max(abs(t), 1e-30):
            return "interval"
        if self.slab_margin(tri, o, d, tn, tx) <= SLAB_EPS:
            return "slab"
        return "unexplained"


def golden_check(name, flat, clf, o, d, tn, tx, tri, t, any_hit):
    """Stride-sample a pass and compare with the CPU golden tracer."""
    R = o.shape[0]
    sub = np.arange(0, R, max(R // GOLDEN_RAYS, 1))[:GOLDEN_RAYS]
    o, d, tn, tx = (np.asarray(a)[sub] for a in (o, d, tn, tx))
    tri = np.asarray(tri)[sub]
    t = np.asarray(t)[sub]
    t0 = time.time()
    g = trace_cpu_golden(flat, o, d, tn, tx, any_hit=any_hit)
    raw = int((tri != g.tri).sum())
    if any_hit:
        bad = np.nonzero((tri >= 0) != (g.tri >= 0))[0]
        tie_aware = len(bad)
    else:
        tie_aware = golden_mismatches(tri, t, g.tri, g.t)
        diff = np.nonzero(tri != g.tri)[0]
        both = (tri[diff] >= 0) & (g.tri[diff] >= 0)
        ulp = np.abs(t[diff].view(np.int32).astype(np.int64)
                     - g.t[diff].view(np.int32).astype(np.int64))
        bad = diff[~(both & np.isfinite(t[diff]) & np.isfinite(g.t[diff])
                     & (ulp <= 4))]
    classes = {}
    for i in bad:
        kinds = []
        for mine, other in ((tri[i], g.t[i]), (g.tri[i], t[i])):
            if mine >= 0:
                kinds.append(clf.classify(int(mine), o[i], d[i], float(tn[i]),
                                          float(tx[i]), float(other)))
        kind = next((k for k in kinds if k != "unexplained"), "unexplained")
        classes[kind] = classes.get(kind, 0) + 1
    log(f"  golden {name:14s} sampled={len(sub)} raw_id_diff={raw} "
        f"non_tie={tie_aware} classes={classes} "
        f"(golden {time.time() - t0:.1f}s)")
    check(classes.get("unexplained", 0) == 0, f"{name}: unexplained residue")
    check(tie_aware <= MAX_CLASSIFIED_FRAC * len(sub),
          f"{name}: {tie_aware} classified residues exceed the allowance")
    return tie_aware


# ---------------------------------------------------------------- phases

def pass_rays(r, cam, res, mode):
    """The rays of one Renderer.render pass and render's own hits on them.

    Primary: render's hits (pixel order) put back in batch order. Shadow
    and AO: the secondary batch gen_secondary builds from those hits, and
    the secondary hits render returned; tracing the batch again with
    Renderer.trace_secondary (the call render makes) must give the same
    ids, which ties the batch to what render traced."""
    cfg = r.cfg
    ca = raygen.camera_arrays(cam, cfg.width, cfg.height)
    order, _ = pixel_table(cfg.width, cfg.height)
    batch = raygen.primary(ca, cfg.width, cfg.height, jnp.asarray(order))
    slot = np.asarray(batch.slot_to_id)
    tri, t = res.hit_tri[slot], res.hit_t[slot]
    if mode == "primary":
        return batch, tri, t, False
    sec, any_hit = r.gen_secondary(cam, mode, batch, jnp.asarray(tri),
                                   jnp.asarray(t),
                                   key=jax.random.PRNGKey(cfg.seed))
    stri, st, _, _ = r.trace_secondary(sec, mode)
    np.testing.assert_array_equal(np.asarray(stri),
                                  np.asarray(res.secondary_tri))
    return sec, np.asarray(res.secondary_tri), np.asarray(st), any_hit


def denormal_probe():
    """Whether the card keeps f32 subnormals: 1e-30 * 1e-10 = 1e-40 from
    two runtime inputs (nothing to fold), in an XLA fusion and in a Triton
    kernel built like the ww kernel. Informational: the golden agreement
    is what holds the kernel's arithmetic to the reference."""
    from jax.experimental import pallas as pl

    x = jnp.full((16,), 1e-30, jnp.float32)
    y = jnp.full((16,), 1e-10, jnp.float32)
    xla = jax.jit(lambda a, b: a * b)(x, y)

    def mul(a_ref, b_ref, o_ref):
        o_ref[...] = a_ref[...] * b_ref[...]

    tri = pl.pallas_call(mul, out_shape=jax.ShapeDtypeStruct((16,),
                                                             jnp.float32),
                         backend="triton")(x, y)
    return float(xla[0]), float(tri[0])


def one_card():
    cam = default_camera("conference")
    t0 = time.time()
    scene = get_scene("conference")
    bcfg = BuildConfig(builder="binned_sah")
    flat = build_accel(scene, bcfg, use_cache=True)
    log(f"[main] conference tris={scene.num_tris} nodes={flat.nodes.shape[0]}"
        f" woop_rows={flat.woop.shape[0]} build+load {time.time()-t0:.1f}s")
    clf = Classifier(flat)
    r = Renderer(scene, bcfg, RenderConfig(width=W, height=H, engine="auto"),
                 flat=flat)
    log(f"[main] engine auto -> {r.engine}")
    check(r.engine == "ww", "auto must resolve to the GPU kernel on a GPU")
    results = {}
    for mode in ("primary", "shadow", "ao"):
        res, wall = best_wall(lambda: r.render(cam, mode=mode), reps=2)
        img = res.image
        check(img.shape == (H, W, 3) and np.isfinite(img).all(),
              f"{mode}: image shape or values")
        hit_rate = float((res.hit_tri >= 0).mean())
        check(hit_rate > 0.5, f"{mode}: hit rate {hit_rate}")
        stages = {k: round(v, 3) for k, v in res.stats.items()
                  if not k.startswith("rays_")}
        log(f"[main] {mode:8s} frame wall {wall*1e3:.2f} ms (informational) "
            f"hit_rate={hit_rate:.4f} stages_ms={stages}")
        results[mode] = res
    log("[golden] closest hit: ids tie-aware (4 ulps); any hit: flags")
    for mode in ("primary", "shadow", "ao"):
        b, tri, t, any_hit = pass_rays(r, cam, results[mode], mode)
        golden_check(mode, flat, clf, b.orig, b.dirn, b.tmin, b.tmax,
                     tri, t, any_hit)

    # --- LBVH device build (the per-frame rebuild path) ---------------
    from ntrace_tpu.bvh.lbvh import build_lbvh_flat

    lcfg = BuildConfig(builder="lbvh")
    lflat, lwall = best_wall(lambda: build_lbvh_flat(scene, lcfg), reps=2)
    log(f"[lbvh] build_lbvh_flat wall {lwall*1e3:.2f} ms "
        f"({lwall*1e3/(scene.num_tris/1e6):.1f} ms/Mtri, informational) "
        f"nodes={lflat.nodes.shape[0]}")
    rl = Renderer(scene, lcfg, RenderConfig(width=W, height=H,
                                            engine="auto"), flat=lflat)
    lres = rl.render(cam, mode="primary")
    b, tri, t, _ = pass_rays(rl, cam, lres, "primary")
    golden_check("lbvh primary", lflat, Classifier(lflat), b.orig, b.dirn,
                 b.tmin, b.tmax, tri, t, False)

    # --- kernel vs plain XLA ------------------------------------------
    rx = Renderer(scene, bcfg, RenderConfig(width=W, height=H,
                                            engine="stack2"), flat=flat)
    for mode in ("primary", "ao"):
        walls, outs = {}, {}
        for name, rr in (("stack2", rx), ("ww", r)):
            outs[name], walls[name] = best_wall(
                lambda: rr.render(cam, mode=mode), reps=3)
        k, x = outs["ww"], outs["stack2"]
        if mode == "ao":  # any hit: occluded flags
            ktri = np.asarray(k.secondary_tri)
            xtri = np.asarray(x.secondary_tri)
            non_tie = int(((ktri >= 0) != (xtri >= 0)).sum())
        else:
            ktri, xtri = k.hit_tri, x.hit_tri
            non_tie = golden_mismatches(ktri, k.hit_t, xtri, x.hit_t)
        log(f"[kernel] {mode:8s} render wall: stack2 "
            f"{walls['stack2']*1e3:.2f} ms, ww {walls['ww']*1e3:.2f} ms; "
            f"rays={ktri.shape[0]} raw_id_diff={int((ktri != xtri).sum())} "
            f"non_tie={non_tie}")
        check(non_tie <= MAX_CLASSIFIED_FRAC * ktri.shape[0],
              f"{mode}: kernel vs stack2")


def four_cards(n):
    """The ray data-parallel tier on n cards against one device."""
    from ntrace_tpu.parallel.mesh import make_mesh, render_step_sharded_unified

    check(len(jax.devices()) >= n, f"need {n} devices")
    scene = get_scene("conference")
    bcfg = BuildConfig(builder="binned_sah")
    flat = build_accel(scene, bcfg, use_cache=True)
    cam = default_camera("conference")
    r = Renderer(scene, bcfg, RenderConfig(width=W, height=H,
                                           engine="stack2"), flat=flat)
    ca = raygen.camera_arrays(cam, W, H)
    order, _ = pixel_table(W, H)
    b = raygen.primary(ca, W, H, jnp.asarray(order))
    light = jnp.asarray(r._default_light(cam), jnp.float32)
    for engine in ("stack2", "ww"):
        out = {}
        for k in (1, n):
            mesh = make_mesh(k)
            (color, hits), wall = best_wall(
                lambda: jax.block_until_ready(render_step_sharded_unified(
                    mesh, r.ut_dev, r.ut_nodes, r.geom_normals, b.orig,
                    b.dirn, b.tmin, b.tmax, light, eps=float(r.eps),
                    engine=engine)))
            out[k] = (np.asarray(color), int(hits), wall)
        c1, h1, w1 = out[1]
        cn, hn, wn = out[n]
        check(np.isfinite(cn).all() and cn.shape == (W * H, 3),
              f"{engine}: sharded colours")
        check(hn == h1, f"{engine}: hits {hn} on {n} cards vs {h1} on one")
        np.testing.assert_array_equal(cn, c1)
        log(f"[cards] {engine:6s} frame step (primary+shadow+shade+psum) "
            f"wall: 1 device {w1*1e3:.2f} ms, {n} devices sharded "
            f"{wn*1e3:.2f} ms; hits {hn}; colours equal")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the ray data-parallel tier on 4 cards")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        sys.exit(1)
    enable_compile_cache()
    n = len(jax.devices())
    log(f"[device] kind={dev.device_kind} count={n} jax={jax.__version__}")
    log(f"[device] card: {card_name_and_power_limit()}")
    xla, tri = denormal_probe()
    log(f"[device] f32 1e-30*1e-10 from runtime inputs: XLA {xla:.4e}, "
        f"Triton {tri:.4e} (0 means subnormals are flushed)")
    t0 = time.time()
    if args.cards > 1:
        four_cards(args.cards)
    else:
        one_card()
    log(f"[done] {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": n}}),
        flush=True)


if __name__ == "__main__":
    main()
