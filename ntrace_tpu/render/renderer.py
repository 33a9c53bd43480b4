"""Per-frame orchestration: build -> raygen -> trace -> secondary -> shade.

Reference parity (~ rt/cuda/Renderer.{cpp,hpp} + RendererKernels.cu,
SURVEY.md SS3.2): Renderer owns the accel build, primary raygen, the
per-ray-type secondary passes (shadow any-hit / AO any-hit / diffuse
closest-hit batches, optionally Morton-sorted), a shading kernel, and the
framebuffer. Batching caps in-flight rays (max_batch_rays ~ the reference's
1-4M cap) by looping the tracer over chunks.

Shading model (the reference's debug/benchmark shading, not a PBR renderer):
  primary: |unit geometric normal|, black background
  shadow : normal shading * (0.25 + 0.75 * unoccluded)
  ao     : normal shading * mean(unoccluded samples)
  diffuse: normal shading * 0.5 + 0.5 * bounce-hit normal shading
  path   : diffuse-material path with `bounces` bounces, emissive lights
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ntrace_tpu.bvh.flatten import FlatBVH, flatten_bvh
from ntrace_tpu.bvh.median import build_median_bvh
from ntrace_tpu.core import BuildConfig, Camera, RenderConfig, Scene
from ntrace_tpu.device import check_kernel_backend, default_engine
from ntrace_tpu.ray import pixel_table, raygen
from ntrace_tpu.ray.raybatch import RayBatch, morton_sort_rays
from ntrace_tpu.bvh.wide import build_wide_table
from ntrace_tpu.trace.persistent import trace_persistent
from ntrace_tpu.trace.wide_jax import trace_wide
from ntrace_tpu.trace.stack_jax import trace_stack
from ntrace_tpu.trace.stack2_jax import trace_stack2
from ntrace_tpu.trace.unified import unify_tables
from ntrace_tpu.trace.ww_kernel import trace_ww
from ntrace_tpu.utils.timing import StageTimer


@dataclass
class RenderResult:
    image: np.ndarray                     # (H, W, 3) float32 linear
    hit_tri: np.ndarray                   # (H*W,) int32 primary hits (pixel order)
    hit_t: np.ndarray                     # (H*W,) float32
    stats: dict = field(default_factory=dict)
    # Secondary pass's hit ids (shadow/ao/diffuse) in traced batch order,
    # left on the device: see Renderer.gen_secondary / trace_secondary.
    secondary_tri: jax.Array | None = None


def build_accel(scene: Scene, cfg: BuildConfig = BuildConfig(),
                use_cache: bool = False) -> FlatBVH:
    """Build the structure `cfg.builder` names; with use_cache, through the
    on-disk accel cache (utils/cache.py)."""
    if use_cache:
        from ntrace_tpu.utils import cache as accel_cache

        hit = accel_cache.load_accel(scene, cfg)
        if hit is not None:
            return hit
        flat = build_accel(scene, cfg, use_cache=False)
        accel_cache.save_accel(scene, cfg, flat)
        return flat
    if cfg.builder in ("median", "golden"):
        bvh = build_median_bvh(scene, cfg)
        return flatten_bvh(bvh, scene)
    if cfg.builder == "lbvh":
        from ntrace_tpu.bvh.lbvh import build_lbvh_flat

        return build_lbvh_flat(scene, cfg)
    if cfg.builder == "hlbvh":
        from ntrace_tpu.bvh.hlbvh import build_hlbvh_flat

        return build_hlbvh_flat(scene, cfg)
    if cfg.builder == "kdtree":
        from ntrace_tpu.bvh.kdtree import build_kdtree

        return build_kdtree(scene, cfg)
    if cfg.builder in ("sbvh", "binned_sah"):
        from ntrace_tpu.bvh.sbvh import build_sbvh

        bvh = build_sbvh(scene, cfg)
        return flatten_bvh(bvh, scene)
    raise ValueError(f"unknown builder {cfg.builder!r}")


def normal_color(geom_normals, hit_tri):
    """|unit geometric normal| debug shading; black on miss.

    Module-level so the multi-chip step (parallel/mesh.py) shades with the
    SAME code as the single-chip renderer (no silent drift).
    """
    tri = jnp.maximum(hit_tri, 0)
    gn = geom_normals[tri]
    gn = gn / (jnp.linalg.norm(gn, axis=-1, keepdims=True) + 1e-30)
    col = jnp.abs(gn)
    return jnp.where(hit_tri[:, None] >= 0, col, 0.0)


def shadow_mix(base_col, lit):
    """The reference's shadow-mode mix: 25% ambient + 75% direct."""
    return base_col * (0.25 + 0.75 * lit)[:, None]


def seeded_closest_trace(tracer, orig, dirn, tmin, tmax, *, stride=16,
                         window=2, slack=np.float32(1.05)):
    """Closest-hit trace with a depth-prepass tmax seed + EXACT fixup.

    Pixel-Morton ray order makes every `stride` consecutive slots a screen
    tile; tracing one ray per tile (pass 0) and seeding each tile's tmax
    with a windowed max of neighbouring prepass depths lets the main pass
    traverse with a tight per-ray [tmin, seed] segment -- the hitT culling
    that normally only develops late in traversal is available from step
    one. Rays that report a miss under a BINDING seed are retraced with
    their original tmax (pass 2, everyone else dead-marked), so results
    are exactly those of a plain trace: a hit under a smaller tmax is the
    true closest hit, and any true hit beyond the seed is recovered by the
    fixup. The seed heuristic affects only speed, never the image.
    """
    R = orig.shape[0]
    pre = tracer(orig[::stride], dirn[::stride], tmin[::stride],
                 tmax[::stride], False)
    pt = jnp.where(pre[0] >= 0, pre[1], jnp.float32(np.inf))
    wmax = pt
    for s in range(1, window + 1):
        wmax = jnp.maximum(wmax, jnp.roll(pt, s))
        wmax = jnp.maximum(wmax, jnp.roll(pt, -s))
    seed = jnp.repeat(wmax * slack, stride, total_repeat_length=pt.shape[0] * stride)[:R]
    tx1 = jnp.minimum(jnp.where(jnp.isfinite(seed), seed, tmax), tmax)
    tri1, t1, u1, v1 = tracer(orig, dirn, tmin, tx1, False)
    need = (tri1 < 0) & (tx1 < tmax)
    tx2 = jnp.where(need, tmax, tmin)   # non-fixup rays are dead lanes
    tri2, t2, u2, v2 = tracer(orig, dirn, tmin, tx2, False)
    return tuple(
        jnp.where(need, b, a)
        for a, b in zip((tri1, t1, u1, v1), (tri2, t2, u2, v2)))


def subset_seeded_trace(tracer, sub_tracer, orig, dirn, tmin, tmax):
    """Closest-hit trace with a sparse-SUBSET geometry tmax seed. EXACT.

    seeded_closest_trace's depth-prepass seed needs neighbour coherence
    (screen tiles), which bounce rays don't have. But an upper bound on
    each ray's OWN closest t comes from tracing a 1/K subset of the
    triangles: a subset hit is a real scene hit, so t_sub >= t_closest,
    and the main pass can traverse with tmax' ~ t_sub -- hitT pruning
    from step one instead of developing late.

    Exactness needs care at the boundary: the slab test's box-entry
    arithmetic ((lo - o) * inv_d) rounds a few ulps ABOVE the true hit
    t, so tmax' = nextafter(t_sub) can prune the very node holding the
    hit. Two guards make the result
    bit-identical to a plain trace: a small multiplicative slack on the
    seed, and seeded_closest_trace's exact FIXUP -- any ray that misses
    under a BINDING seed retraces with its original tmax (everyone else
    dead-marked, so the fixup pass ends after one step for them). A hit under a smaller tmax is the true closest hit with
    the true (t, lowest-id) tie-break, since every candidate with
    t <= t_sub < tmax' is in range and the subset triangle itself is in
    the full tables.
    """
    stri, st, _, _ = sub_tracer(orig, dirn, tmin, tmax, False)
    seed = jnp.where(
        stri >= 0,
        jnp.minimum(st * np.float32(1.0 + 1e-4), tmax), tmax)
    tri1, t1, u1, v1 = tracer(orig, dirn, tmin, seed, False)
    need = (tri1 < 0) & (seed < tmax)
    tx2 = jnp.where(need, tmax, tmin)   # non-fixup rays are dead lanes
    tri2, t2, u2, v2 = tracer(orig, dirn, tmin, tx2, False)
    return tuple(
        jnp.where(need, b, a)
        for a, b in zip((tri1, t1, u1, v1), (tri2, t2, u2, v2)))


def staged_closest_trace(tracer, orig, dirn, tmin, tmax, radii):
    """EXACT multi-interval closest-hit trace for long incoherent rays.

    A per-ray kernel bounds each ray's traversal by its own running hitT;
    a lockstep batch waits for its slowest ray, and full-length bounce rays
    make that ray walk most of the scene. Decomposing the interval bounds
    every pass by a short segment:

      pass k: trace [tn, tn + radii[k]) -- AO-class traversal economics.
        A hit here IS the global closest: traversal with tmax clamped to
        the cut is exhaustive within the interval, and every candidate
        beyond it has strictly larger t.
      resolved lanes are DEAD-MARKED in place (tmax = tmin) for later
        passes -- no sort, no compaction (the seeded_closest_trace fixup
        mechanism).
      final pass: unresolved lanes re-cover the FULL [tn, tx), so
        rounding at the stage cuts is never consulted; a lane with its
        closest hit exactly AT a cut (excluded by the stage's strict
        t < tmax) is recovered here with the true (t, lowest-id)
        tie-break.

    radii: ascending absolute near-interval lengths (world units).
    Returns (tri, t, u, v) bit-identical to tracer(o, d, tn, tx, False)
    on hits and hit ids (miss t follows the plain trace's convention via
    the final pass).
    """
    res = None
    acc = None
    for rc in radii:
        t1 = jnp.minimum(tmax, tmin + jnp.float32(rc))
        txk = t1 if res is None else jnp.where(res, tmin, t1)
        cur = tracer(orig, dirn, tmin, txk, False)
        got = cur[0] >= 0
        now = got | (t1 >= tmax)
        if acc is None:
            acc, res = list(cur), now
        else:
            new = ~res & now
            acc = [jnp.where(new, c, a) for c, a in zip(cur, acc)]
            res = res | now
    txf = jnp.where(res, tmin, tmax)
    fin = tracer(orig, dirn, tmin, txf, False)
    return tuple(jnp.where(res, a, f) for a, f in zip(acc, fin))


def _trace_batched(tracer, batch: RayBatch, cap: int, any_hit: bool):
    """Loop the tracer over <=cap-ray chunks (the in-flight ray cap).

    Device OOM retries with a halved cap (SURVEY.md SS6.3: the benchmark
    harness's failure-handling policy) down to a 4k floor.
    """
    import sys

    n = batch.num_rays
    while True:
        try:
            if n <= cap:
                return tracer(batch.orig, batch.dirn, batch.tmin, batch.tmax,
                              any_hit)
            outs = []
            for s in range(0, n, cap):
                e = min(s + cap, n)
                outs.append(tracer(
                    batch.orig[s:e], batch.dirn[s:e],
                    batch.tmin[s:e], batch.tmax[s:e], any_hit,
                ))
            return tuple(jnp.concatenate([o[i] for o in outs]) for i in range(4))
        except Exception as err:  # jaxlib.XlaRuntimeError has no stable path
            if "RESOURCE_EXHAUSTED" not in str(err) or cap <= 4096:
                raise
            cap //= 2
            print(f"[renderer] device OOM; retrying with ray cap {cap}",
                  file=sys.stderr)


def _compact_trace(tracer, batch: RayBatch, cap: int, any_hit: bool,
                   compact: str = "auto"):
    """Trace only the live prefix of a dead-at-end-sorted batch.

    The reference's kepler_dynamic_fetch keeps lanes full by fetching
    fresh rays as lanes terminate (SURVEY.md SS3.3). The analogue here is
    shape-level: morton_sort_rays already sorts dead rays (tmax <= tmin)
    to the END, so between-pass compaction is just truncating to the live
    prefix -- blocks of dead rays are never launched. The prefix
    is padded to a power of two (>=8192) so at most ~log2(R) distinct
    kernel shapes ever compile; results are padded back to full length
    with miss sentinels.

    Callers must pass a batch whose dead rays are at the end (i.e. after
    morton_sort_rays); `compact` in {"on", "off", "auto"} -- auto engages
    when the live fraction is below 3/4 (one host sync of a scalar sum,
    piggybacking on the per-stage block_until_ready the renderer already
    does).
    """
    n = batch.num_rays
    if compact != "off" and n > 8192:
        live = int(jnp.sum(batch.tmax > batch.tmin))
        padded = max(8192, 1 << max(live - 1, 1).bit_length())
        if padded < n and (compact == "on" or live <= (3 * n) // 4):
            sub = RayBatch(batch.orig[:padded], batch.dirn[:padded],
                           batch.tmin[:padded], batch.tmax[:padded],
                           None)
            tri, t, u, v = _trace_batched(tracer, sub, cap, any_hit)
            pad = n - padded
            tri = jnp.concatenate([tri, jnp.full((pad,), -1, tri.dtype)])
            t = jnp.concatenate([t, jnp.zeros((pad,), t.dtype)])
            u = jnp.concatenate([u, jnp.zeros((pad,), u.dtype)])
            v = jnp.concatenate([v, jnp.zeros((pad,), v.dtype)])
            return tri, t, u, v
    return _trace_batched(tracer, batch, cap, any_hit)


ENGINES = ("stack", "stack2", "ww", "bvh8", "kdtree", "cpu_golden")


def _chunk_for(r: int, chunk: int) -> int:
    """The chunk a batch of r rays runs in: `chunk`, or the next power of
    two >= r (at least 128) when that is smaller."""
    return min(chunk, max(128, 1 << max(r - 1, 1).bit_length()))


def _pad_rays(o, d, tn, tx, multiple):
    """Pad a ray batch to a multiple of `multiple` with zero-length rays."""
    pad = (-o.shape[0]) % multiple
    if not pad:
        return o, d, tn, tx
    return (jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)]),
            jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)]),
            jnp.concatenate([tn, jnp.zeros((pad,), tn.dtype)]),
            jnp.concatenate([tx, jnp.zeros((pad,), tx.dtype)]))


def make_tracer(flat, engine: str, cfg: RenderConfig = RenderConfig()):
    """(tracer, tables) for one structure.

    tracer(o, d, tn, tx, any_hit) -> (tri, t, u, v), with tri = -1 and
    t = inf on a miss. `flat` is a FlatBVH, or a FlatKDTree for
    engine="kdtree". `tables` are the device arrays the tracer reads:
    (nodes, woop, tri_index) for "stack", (unified table, n_nodes) for
    the unified-table engines, None otherwise.
    """
    if engine == "stack":
        tables = tuple(jax.device_put(jnp.asarray(a)) for a in (
            flat.nodes, flat.woop, flat.tri_index))

        def tracer(o, d, tn, tx, any_hit):
            return trace_stack(*tables, o, d, tn, tx, any_hit=any_hit)
        return tracer, tables
    if engine == "cpu_golden":  # host reference tracer (slow, exact)
        from ntrace_tpu.trace.cpu import trace_cpu_golden

        def tracer(o, d, tn, tx, any_hit):
            rec = trace_cpu_golden(flat, np.asarray(o), np.asarray(d),
                                   np.asarray(tn), np.asarray(tx),
                                   any_hit=any_hit)
            return tuple(jnp.asarray(a) for a in (rec.tri, rec.t, rec.u,
                                                  rec.v))
        return tracer, None
    chunk = min(cfg.max_batch_rays, 1 << 13)
    if engine == "bvh8":  # 8-wide one-dispatch engine
        wt = build_wide_table(flat)
        table = jax.device_put(jnp.asarray(wt.table))

        def tracer(o, d, tn, tx, any_hit):
            r = o.shape[0]
            c = _chunk_for(r, chunk)
            out = trace_wide(table, wt.n_node_rows,
                             *_pad_rays(o, d, tn, tx, c),
                             any_hit=any_hit, chunk=c)
            return tuple(x[:r] for x in out)
        return tracer, None
    if engine not in ("kdtree", "ww", "stack2"):
        raise ValueError(f"unknown engine {engine!r}; known: {ENGINES}")
    if engine == "ww":  # refuse before building tables the kernel can't use
        check_kernel_backend(cfg.interpret)
    ut, n_nodes = unify_tables(flat)
    ut = jax.device_put(jnp.asarray(ut))
    if engine != "kdtree":
        return unified_tracer(ut, n_nodes, engine, cfg), (ut, n_nodes)
    # interval-stack kd engine
    from ntrace_tpu.trace.kdtree_jax import trace_kd

    kd_lo, kd_hi = jnp.asarray(flat.root_lo), jnp.asarray(flat.root_hi)

    def tracer(o, d, tn, tx, any_hit):
        r = o.shape[0]
        c = _chunk_for(r, chunk)
        out = trace_kd(ut, n_nodes, kd_lo, kd_hi,
                       *_pad_rays(o, d, tn, tx, c),
                       any_hit=any_hit, chunk=c)
        return tuple(x[:r] for x in out)
    return tracer, (ut, n_nodes)


def unified_tracer(ut, n_nodes, engine: str,
                   cfg: RenderConfig = RenderConfig()):
    """tracer(o, d, tn, tx, any_hit) over a unified table (trace/unified.py)
    for engine "ww" (the per-ray while-while kernel) or "stack2" (the
    lockstep XLA engine, chunked through trace/persistent.py above one
    chunk). make_tracer and the sharded tiers of parallel/mesh.py both
    build their tracers here, so one engine name means one path."""
    if engine == "ww":
        check_kernel_backend(cfg.interpret)

        def tracer(o, d, tn, tx, any_hit):
            return trace_ww(ut, n_nodes, o, d, tn, tx, any_hit,
                            interpret=cfg.interpret)
        return tracer
    if engine != "stack2":
        raise ValueError(f"no unified-table tracer for engine {engine!r}")
    chunk = min(cfg.max_batch_rays, 1 << 13)

    def tracer(o, d, tn, tx, any_hit):
        r = o.shape[0]
        if r <= chunk:
            return trace_stack2(ut, n_nodes, o, d, tn, tx, any_hit=any_hit)
        out = trace_persistent(ut, n_nodes, *_pad_rays(o, d, tn, tx, chunk),
                               any_hit=any_hit, chunk=chunk)
        return tuple(x[:r] for x in out)
    return tracer


class Renderer:
    def __init__(self, scene: Scene, build_cfg: BuildConfig = BuildConfig(),
                 cfg: RenderConfig = RenderConfig(), flat: FlatBVH | None = None):
        from ntrace_tpu.bvh.kdtree import FlatKDTree, build_kdtree, kd_to_flatbvh

        self.scene = scene
        self.cfg = cfg
        self.build_cfg = build_cfg
        self.timer = StageTimer()
        engine = default_engine() if cfg.engine == "auto" else cfg.engine
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; known: "
                             f"{('auto',) + ENGINES}")
        self.engine = engine
        with self.timer.stage("build"):
            self.flat = flat if flat is not None else build_accel(scene,
                                                                  build_cfg)
        if engine == "kdtree" and not isinstance(self.flat, FlatKDTree):
            # The interval-stack kd engine needs a kd accel.
            self.flat = build_kdtree(scene, build_cfg)
        if isinstance(self.flat, FlatKDTree) and engine != "kdtree":
            # Every other engine traverses the kd tree's cell boxes as a
            # FlatBVH (bvh/kdtree.py kd_to_flatbvh).
            self.flat_kd = self.flat
            self.flat = kd_to_flatbvh(self.flat)
        self._tracer, tables = make_tracer(self.flat, engine, cfg)
        if engine == "stack":
            self.flat_dev = tables
        elif tables is not None:
            self.ut_dev, self.ut_nodes = tables
        gn = scene.geometric_normals()
        self.geom_normals = jax.device_put(jnp.asarray(gn))
        mats = np.stack([np.asarray(m.diffuse, np.float32) for m in scene.materials])
        emis = np.stack([np.asarray(m.emissive, np.float32) for m in scene.materials])
        self.mat_diffuse = jax.device_put(jnp.asarray(mats))
        self.mat_emissive = jax.device_put(jnp.asarray(emis))
        self.mat_ids = jax.device_put(jnp.asarray(scene.mat_ids))
        lo, hi = scene.bbox()
        self.scene_lo = jnp.asarray(lo)
        self.scene_hi = jnp.asarray(hi)
        self.scene_scale = float(np.linalg.norm(hi - lo))
        self.eps = jnp.float32(self.scene_scale * 1e-4)

    def trace_primary(self, orig, dirn, tmin, tmax):
        """Primary-ray closest-hit trace with the configured seeding policy
        (shared by render() and bench.py, so both measure one path)."""
        if (self.cfg.seed_primary == "on" and orig.shape[0] <= self._cap()
                and orig.shape[0] >= 16 * 4):
            return seeded_closest_trace(self._tracer, orig, dirn, tmin, tmax)
        batch = RayBatch(orig, dirn, tmin, tmax)
        return _trace_batched(self._tracer, batch, self._cap(), False)

    def _cap(self):
        """Per-dispatch ray cap: engines other than the v1 stack engine
        chunk internally, so they take whole batches (up to 4M rays)."""
        if self.engine == "stack":
            return self.cfg.max_batch_rays
        return max(self.cfg.max_batch_rays, 1 << 22)

    # -- shading helpers (all jitted via callers) -------------------------

    def _unit_normals(self, hit_tri, dirn):
        n, _ = raygen.surface_frame(hit_tri, dirn, self.geom_normals, 0.0)
        return n

    def _normal_color(self, hit_tri):
        return normal_color(self.geom_normals, hit_tri)

    # -- ray-type passes ---------------------------------------------------

    def gen_secondary(self, camera: Camera, mode: str, batch, tri, t,
                      key=None):
        """Secondary RayBatch for `mode` exactly as render() builds it
        (dead rays zero-length, optional Morton coherence sort).

        Returns (RayBatch, any_hit). Shared by render(), the matrix
        benchmark and chip_smoke.py, so they trace the very batch the
        renderer traces.
        """
        cfg = self.cfg
        key = jax.random.PRNGKey(cfg.seed) if key is None else key
        hit_mask = tri >= 0
        normals = self._unit_normals(tri, batch.dirn)
        hit_pos = batch.orig + jnp.where(hit_mask, t, 0.0)[:, None] * batch.dirn
        if mode == "shadow":
            light = jnp.asarray(self._default_light(camera), jnp.float32)
            sbatch = raygen.shadow(hit_pos, normals, light, self.eps)
            sbatch = RayBatch(sbatch.orig, sbatch.dirn, sbatch.tmin,
                              jnp.where(hit_mask, sbatch.tmax, 0.0),
                              sbatch.slot_to_id)
            return sbatch, True
        if mode in ("ao", "diffuse"):
            S = cfg.samples
            gen = raygen.ao if mode == "ao" else raygen.diffuse
            arg = cfg.ao_radius if mode == "ao" else self.scene_scale * 10.0
            sec = gen(key, hit_pos, normals, S, jnp.float32(arg), self.eps)
            sec = RayBatch(sec.orig, sec.dirn, sec.tmin,
                           jnp.where(jnp.repeat(hit_mask, S), sec.tmax, 0.0),
                           sec.slot_to_id)
            if cfg.sort_secondary:
                sec = morton_sort_rays(sec, self.scene_lo, self.scene_hi,
                                       direction_major=(mode != "ao"))
            return sec, mode == "ao"
        raise ValueError(f"no secondary pass for mode {mode!r}")

    def trace_secondary(self, sec, mode: str):
        """Trace a gen_secondary (or path-bounce) batch the way render()
        does: shadow and AO any-hit, diffuse closest-hit through the
        secondary tracer; a Morton-sorted batch traces its live prefix
        only. Returns (tri, t, u, v) in the batch's (sorted) order.
        render() and chip_smoke.py both call this."""
        any_hit = mode in ("shadow", "ao")
        if mode == "shadow":
            return _trace_batched(self._tracer, sec, self._cap(), True)
        tr = self._secondary_tracer(long_rays=(mode == "diffuse"))
        if self.cfg.sort_secondary:  # dead rays are at the end
            return _compact_trace(tr, sec, self._cap(), any_hit,
                                  compact=self.cfg.compact_rays)
        return _trace_batched(tr, sec, self._cap(), any_hit)

    def render(self, camera: Camera, mode: str | None = None) -> RenderResult:
        cfg = self.cfg
        mode = mode or cfg.mode
        W, H = cfg.width, cfg.height
        timer = StageTimer()
        order, _ = pixel_table(W, H)
        cam = raygen.camera_arrays(camera, W, H)

        with timer.stage("raygen"):
            batch = raygen.primary(cam, W, H, jnp.asarray(order))
            jax.block_until_ready(batch.dirn)
        with timer.stage("trace_primary"):
            tri, t, u, v = self.trace_primary(
                batch.orig, batch.dirn, batch.tmin, batch.tmax)
            jax.block_until_ready(t)
        timer.count("rays_primary", batch.num_rays)

        hit_mask = tri >= 0
        normals = self._unit_normals(tri, batch.dirn)
        t_safe = jnp.where(hit_mask, t, 0.0)
        hit_pos = batch.orig + t_safe[:, None] * batch.dirn
        base_col = self._normal_color(tri)
        key = jax.random.PRNGKey(cfg.seed)
        secondary_tri = None

        if mode == "primary":
            color = base_col
        elif mode == "textured":
            from ntrace_tpu.render import texture as tex

            if not hasattr(self, "_atlas"):
                uvs = (self.scene.uvs if self.scene.uvs is not None
                       else np.zeros((self.scene.num_tris, 3, 2), np.float32))
                self._uvs = jax.device_put(jnp.asarray(uvs))
                if cfg.tex_filter == "nearest":
                    self._atlas = jax.device_put(
                        jnp.asarray(tex.build_atlas(self.scene.materials)))
                else:
                    flat_mips, offs, sides = tex.build_mip_atlas(
                        self.scene.materials)
                    self._atlas = jax.device_put(jnp.asarray(flat_mips))
                    self._mip_offs, self._mip_sides = offs, sides
                    self._tex_density = jax.device_put(jnp.asarray(
                        tex.tri_texel_density(uvs, self.scene.tri_verts(),
                                              sides[0])))
            uv = tex.interpolate_uv(self._uvs, tri, u, v)
            mat = self.mat_ids[jnp.maximum(tri, 0)]
            if cfg.tex_filter == "nearest":
                albedo = tex.sample_atlas(self._atlas, mat, uv)
            elif cfg.tex_filter == "bilinear":
                albedo = tex.sample_atlas_bilinear(
                    self._atlas, self._mip_offs, self._mip_sides, mat, uv)
            else:  # trilinear (mipmapped, ray-cone LOD)
                pixel_angle = jnp.float32(
                    np.radians(camera.fov_deg) / cfg.height)
                ndotd_s = jnp.sum(normals * batch.dirn, axis=-1)
                lod = tex.cone_lod(self._tex_density[jnp.maximum(tri, 0)],
                                   t_safe, ndotd_s, pixel_angle)
                albedo = tex.sample_atlas_trilinear(
                    self._atlas, self._mip_offs, self._mip_sides, mat, uv,
                    lod)
            ndotd = jnp.abs(jnp.sum(normals * batch.dirn, axis=-1))
            color = jnp.where(hit_mask[:, None],
                              albedo * (0.2 + 0.8 * ndotd)[:, None], 0.0)
        elif mode == "shadow":
            with timer.stage("raygen_shadow"):
                sbatch, _ = self.gen_secondary(camera, mode, batch, tri, t,
                                               key=key)
                jax.block_until_ready(sbatch.tmax)
            with timer.stage("trace_shadow"):
                stri, *_ = self.trace_secondary(sbatch, mode)
                jax.block_until_ready(stri)
            secondary_tri = stri
            timer.count("rays_shadow", sbatch.num_rays)
            lit = (stri < 0).astype(jnp.float32)
            color = shadow_mix(base_col, lit)
        elif mode in ("ao", "diffuse"):
            S = cfg.samples
            with timer.stage(f"raygen_{mode}"):
                # ao_radius is world units; AO rays sort origin-major,
                # long bounce rays direction-major (see raybatch.py).
                sec, _ = self.gen_secondary(camera, mode, batch, tri, t,
                                            key=key)
                jax.block_until_ready(sec.tmax)
            with timer.stage(f"trace_{mode}"):
                stri, *_ = self.trace_secondary(sec, mode)
                jax.block_until_ready(stri)
            secondary_tri = stri
            timer.count(f"rays_{mode}", sec.num_rays)
            if cfg.sort_secondary:
                from ntrace_tpu.ray.raybatch import unsort

                stri = unsort(stri, sec.slot_to_id)
            if mode == "ao":
                vis = (stri < 0).astype(jnp.float32).reshape(-1, S).mean(axis=1)
                color = base_col * vis[:, None]
            else:
                bounce_col = self._normal_color(stri).reshape(-1, S, 3).mean(axis=1)
                color = base_col * 0.5 + bounce_col * 0.5
        elif mode == "path":
            color = self._path_trace(key, batch, tri, t, timer)
        else:
            raise ValueError(f"unknown mode {mode!r}")

        with timer.stage("shade"):
            fb = jnp.zeros((W * H, 3), jnp.float32)
            fb = fb.at[batch.slot_to_id].set(color)
            img = np.asarray(fb).reshape(H, W, 3)

        from ntrace_tpu.ray.raybatch import unsort as _unsort

        stats = timer.ms()
        result = RenderResult(
            image=img,
            hit_tri=np.asarray(_unsort(tri, batch.slot_to_id)),
            hit_t=np.asarray(_unsort(t, batch.slot_to_id)),
            stats=stats,
            secondary_tri=secondary_tri,
        )
        # Mrays/s per traced pass (kernel time only, reference convention).
        for k in list(stats):
            if k.startswith("rays_"):
                name = k[5:]
                tkey = f"trace_{name}" if name != "primary" else "trace_primary"
                if tkey in stats and stats[tkey] > 0:
                    # stats[k] = ray count; stats[tkey] = ms.
                    result.stats[f"mrays_{name}"] = (
                        stats[k] / 1e6 / (stats[tkey] / 1e3)
                    )
        return result

    def _default_light(self, camera: Camera):
        if any(self.cfg.light):
            return np.asarray(self.cfg.light, np.float32)
        lo, hi = self.scene.bbox()
        # High-center light slightly toward the camera.
        c = (lo + hi) / 2
        return np.array([c[0], hi[1] * 0.95, c[2]], np.float32) * 0.7 + camera.position * 0.3

    def _subset_tracer(self):
        """Tracer over every seed_subset-th triangle, built lazily with the
        renderer's own engine (see subset_seeded_trace)."""
        if not hasattr(self, "_sub_tr"):
            k = max(int(self.cfg.seed_subset), 2)
            sub_scene = Scene(positions=self.scene.positions,
                              indices=self.scene.indices[::k],
                              name=f"{self.scene.name}-sub{k}")
            flat = build_accel(sub_scene, BuildConfig(builder="binned_sah"),
                               use_cache=True)
            engine = "stack2" if self.engine == "kdtree" else self.engine
            self._sub_tr, _ = make_tracer(flat, engine, self.cfg)
        return self._sub_tr

    def _secondary_tracer(self, long_rays: bool):
        """The tracer secondary passes use: for long closest-hit bounces,
        staged (stage_secondary) or subset-seeded (seed_secondary) when
        switched on, else the plain engine tracer. Any-hit calls always
        pass through (they already stop at the first hit)."""
        cfg = self.cfg
        base = self._tracer
        if not long_rays:
            return base
        if cfg.stage_secondary == "on":
            radii = tuple(float(f) * self.scene_scale
                          for f in cfg.stage_radii)

            def tr_staged(o, d, tn, tx, any_hit):
                if any_hit:
                    return base(o, d, tn, tx, True)
                return staged_closest_trace(base, o, d, tn, tx, radii)

            return tr_staged
        if cfg.seed_secondary != "on":
            return base
        sub = self._subset_tracer()

        def tr(o, d, tn, tx, any_hit):
            if any_hit:
                return base(o, d, tn, tx, True)
            return subset_seeded_trace(base, sub, o, d, tn, tx)

        return tr

    def _path_trace(self, key, batch, tri, t, timer):
        """`bounces`-bounce diffuse path tracing with emissive materials."""
        cfg = self.cfg
        R = batch.num_rays
        throughput = jnp.ones((R, 3), jnp.float32)
        radiance = jnp.zeros((R, 3), jnp.float32)
        cur_orig, cur_dirn = batch.orig, batch.dirn
        cur_tri, cur_t = tri, t
        alive = cur_tri >= 0
        # Sky term for primary misses.
        radiance += jnp.where(alive[:, None], 0.0, 0.05)
        for b in range(cfg.bounces + 1):
            mat = self.mat_ids[jnp.maximum(cur_tri, 0)]
            emis = self.mat_emissive[mat]
            diff = self.mat_diffuse[mat]
            radiance += jnp.where(alive[:, None], throughput * emis, 0.0)
            throughput = throughput * jnp.where(alive[:, None], diff, 0.0)
            if b == cfg.bounces:
                break
            normals = self._unit_normals(cur_tri, cur_dirn)
            t_safe = jnp.where(alive, cur_t, 0.0)
            hit_pos = cur_orig + t_safe[:, None] * cur_dirn
            key, sub = jax.random.split(key)
            d = raygen.cosine_hemisphere(sub, normals, (R,))
            o = hit_pos + normals * self.eps
            nb = RayBatch(o, d, jnp.zeros((R,), jnp.float32),
                          jnp.where(alive, jnp.float32(self.scene_scale * 10), 0.0),
                          jnp.arange(R, dtype=jnp.int32))
            if cfg.sort_secondary:
                nb = morton_sort_rays(nb, self.scene_lo, self.scene_hi)
            with timer.stage(f"trace_bounce{b}"):
                btri, bt, _, _ = self.trace_secondary(nb, "diffuse")
                jax.block_until_ready(btri)
            timer.count(f"rays_bounce{b}", R)
            if cfg.sort_secondary:
                from ntrace_tpu.ray.raybatch import unsort

                btri = unsort(btri, nb.slot_to_id)
                bt = unsort(bt, nb.slot_to_id)
                cur_orig, cur_dirn = o, d
            else:
                cur_orig, cur_dirn = nb.orig, nb.dirn
            # Ambient sky for bounce misses.
            sky = (btri < 0) & alive
            radiance += jnp.where(sky[:, None], throughput * 0.8, 0.0)
            alive = alive & (btri >= 0)
            cur_tri, cur_t = btri, bt
        return radiance



def render_frame(scene: Scene, camera: Camera | None = None,
                 cfg: RenderConfig = RenderConfig(),
                 build_cfg: BuildConfig = BuildConfig()) -> RenderResult:
    """One-call convenience: build, render, return the frame."""
    from ntrace_tpu.scenes import default_camera

    camera = camera or default_camera(scene.name)
    return Renderer(scene, build_cfg, cfg).render(camera)
