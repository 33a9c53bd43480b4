"""Multi-device ray-parallelism over a jax.sharding.Mesh.

The reference is single-GPU (SURVEY.md SS3.4); its only parallelism is
within one card. The scaling axis added here is DATA PARALLELISM OVER
RAYS: the BVH (nodes/woop/tri_index) is replicated on every device, ray
batches are sharded along a 1-D `rays` mesh axis, each device traces its
shard with the local engine, and per-frame reductions (hit counts) are
collectives. This composes with any engine because tracing is
embarrassingly parallel across rays.

Rays are the batch dimension; the accel is the "weights". Every scene of
the benchmark fits one card, so the accel is never sharded.

The frame step SHARES the single-device renderer's shading and raygen code
(render/renderer.py normal_color + shadow_mix, ray/raygen.py shadow +
surface_frame): tests/test_parallel.py asserts the sharded frame equals the
Renderer's shadow-mode output pixel-for-pixel on the virtual 8-device mesh.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ntrace_tpu.core import RenderConfig
from ntrace_tpu.ray import raygen
from ntrace_tpu.render.renderer import normal_color, shadow_mix, unified_tracer
from ntrace_tpu.trace.stack_jax import trace_stack


def make_mesh(n_devices: int | None = None, axis: str = "rays") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis,))


def trace_sharded(mesh: Mesh, nodes, woop, tri_index, orig, dirn, tmin, tmax,
                  any_hit: bool = False):
    """Trace with rays sharded over the mesh, accel replicated.

    Ray count must be divisible by mesh size (pad at the caller; the
    renderer's batching already rounds ray counts).
    """
    fn = jax.shard_map(
        partial(trace_stack, any_hit=any_hit),
        mesh=mesh,
        in_specs=(P(), P(), P(), P("rays"), P("rays"), P("rays"), P("rays")),
        out_specs=(P("rays"), P("rays"), P("rays"), P("rays")),
        check_vma=False,
    )
    return jax.jit(fn)(nodes, woop, tri_index, orig, dirn, tmin, tmax)


def _frame_body(tracer, geom_normals, orig, dirn, tmin, tmax,
                light_pos, eps, axis=None):
    """Primary trace -> shadow any-hit -> shadow shading for one ray shard.

    `tracer(o, d, tn, tx, any_hit)` is ANY engine closed over its
    (replicated) tables -- the frame structure is engine-agnostic. Shading
    composes the SAME helpers the Renderer's shadow mode uses. `axis`: mesh
    axis name for the global hit psum (None = single device).
    """
    tri, t, u, v = tracer(orig, dirn, tmin, tmax, False)
    hit = tri >= 0
    normals, _ = raygen.surface_frame(tri, dirn, geom_normals, 0.0)
    base_col = normal_color(geom_normals, tri)
    t_safe = jnp.where(hit, t, 0.0)
    hit_pos = orig + t_safe[:, None] * dirn
    sbatch = raygen.shadow(hit_pos, normals, light_pos, eps)
    stri, *_ = tracer(sbatch.orig, sbatch.dirn, sbatch.tmin,
                      jnp.where(hit, sbatch.tmax, 0.0), True)
    lit = (stri < 0).astype(jnp.float32)
    color = shadow_mix(base_col, lit)
    hits = hit.sum()
    if axis is not None:
        hits = jax.lax.psum(hits, axis)
    return color, hits


def frame_step(nodes, woop, tri_index, geom_normals,
               orig, dirn, tmin, tmax, light_pos, eps, axis=None):
    """_frame_body with the v1 stack engine (kept as the simplest shape)."""
    def tracer(o, d, tn, tx, ah):
        return trace_stack(nodes, woop, tri_index, o, d, tn, tx, any_hit=ah)

    return _frame_body(tracer, geom_normals, orig, dirn, tmin, tmax,
                       light_pos, eps, axis)


def trace_sharded_unified(mesh: Mesh, ut, n_nodes, orig, dirn, tmin, tmax,
                          any_hit: bool = False, engine: str = "stack2",
                          interpret: bool = False):
    """A unified-table engine (stack2, or the ww kernel) under shard_map:
    table replicated, rays sharded; each device traces its own shard with
    the tracer the Renderer builds for that engine
    (render/renderer.py unified_tracer)."""
    cfg = RenderConfig(engine=engine, interpret=interpret)

    def body(ut, o, d, tn, tx):
        return unified_tracer(ut, n_nodes, engine, cfg)(o, d, tn, tx, any_hit)

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P("rays"), P("rays"), P("rays"), P("rays")),
        out_specs=(P("rays"), P("rays"), P("rays"), P("rays")),
        check_vma=False,
    )
    return jax.jit(fn)(ut, orig, dirn, tmin, tmax)


@lru_cache(maxsize=None)
def _render_step(mesh: Mesh, n_nodes: int, engine: str, interpret: bool):
    """The jitted sharded frame step, built once per (mesh, table, engine)
    so repeated frames reuse one compiled program."""
    cfg = RenderConfig(engine=engine, interpret=interpret)

    def step(ut, gn, o, d, tn, tx, light, eps_):
        tracer = unified_tracer(ut, n_nodes, engine, cfg)
        return _frame_body(tracer, gn, o, d, tn, tx, light, eps_,
                           axis="rays")

    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(P(), P(), P("rays"), P("rays"), P("rays"), P("rays"),
                  P(), P()),
        out_specs=(P("rays"), P()),
        check_vma=False,
    ))


def render_step_sharded_unified(mesh: Mesh, ut, n_nodes, geom_normals,
                                orig, dirn, tmin, tmax, light_pos, eps=1e-3,
                                engine: str = "stack2",
                                interpret: bool = False):
    """Full frame step (primary + shadow secondary + shading + stats psum),
    rays sharded over the mesh, on a unified-table engine: stack2 by
    default, or the ww kernel."""
    return _render_step(mesh, n_nodes, engine, interpret)(
        ut, geom_normals, orig, dirn, tmin, tmax, light_pos,
        jnp.float32(eps))


def render_step_sharded(mesh: Mesh, nodes, woop, tri_index, geom_normals,
                        orig, dirn, tmin, tmax, light_pos, eps=1e-3):
    """One full sharded frame step: primary trace -> shadow any-hit ->
    shading -> global stats psum, on the v1 stack engine. It exercises
    replicated-accel + ray-sharded compute and one collective (psum of
    hit counts).
    Returns (color (R,3) sharded by rays, global_hits scalar replicated).
    """
    fn = jax.shard_map(
        partial(frame_step, axis="rays"),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(),
                  P("rays"), P("rays"), P("rays"), P("rays"), P(), P()),
        out_specs=(P("rays"), P()),
        check_vma=False,
    )
    return jax.jit(fn)(nodes, woop, tri_index, geom_normals,
                       orig, dirn, tmin, tmax, light_pos,
                       jnp.float32(eps))
