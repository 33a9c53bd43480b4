"""JAX batch-lockstep while-while traversal engine (correctness engine).

SURVEY.md SS8 M2: the minimum end-to-end slice. All rays in the
batch advance one while-while step per iteration of a single
`lax.while_loop`; per-ray stacks live in a (R, 64) int32 array. The step
function is the SAME code the numpy golden driver executes
(trace/common.py), so results match the CPU golden tracer by construction
up to compiler fma/reassociation differences.

This engine is a correctness oracle for the faster engines. Cost profile:
each step is a (R,16)+(R,12) gather plus ~60 elementwise ops; the loop
runs until the LAST ray finishes, so incoherent batches pay a long tail --
the divergence a per-ray kernel (trace/ww_kernel.py) does not have.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ntrace_tpu.ops.aabb import safe_inv_dir
from ntrace_tpu.trace import common
from ntrace_tpu.trace.common import TraceState, init_state, traversal_step

# TraceState as a pytree (fields are all arrays).
jax.tree_util.register_pytree_node(
    TraceState,
    lambda s: ((s.cur, s.sp, s.stack, s.hit_t, s.hit_tri, s.hit_u, s.hit_v), None),
    lambda _, c: TraceState(*c),
)


@partial(jax.jit, static_argnames=("any_hit",))
def trace_stack(nodes, woop, tri_index, orig, dirn, tmin, tmax, any_hit=False):
    """Trace a ray batch against a flattened BVH.

    nodes (N,16) f32, woop (W,12) f32, tri_index (W,) i32 -- flatten.py layout.
    orig/dirn (R,3) f32; tmin/tmax (R,) f32.
    Returns (hit_tri (R,) i32 [-1 miss], t (R,) f32 [inf miss], u, v).
    """
    orig = orig.astype(jnp.float32)
    dirn = dirn.astype(jnp.float32)
    tmin = jnp.broadcast_to(tmin.astype(jnp.float32), orig.shape[:1])
    tmax = jnp.broadcast_to(tmax.astype(jnp.float32), orig.shape[:1])
    inv_dir = safe_inv_dir(jnp, dirn)

    state = init_state(jnp, orig, tmax)

    def cond(s):
        return common.any_alive(jnp, s)

    def body(s):
        return traversal_step(
            jnp, nodes, woop, tri_index, orig, dirn, inv_dir, tmin, s, any_hit
        )

    state = jax.lax.while_loop(cond, body, state)
    miss = state.hit_tri < 0
    t_out = jnp.where(miss, jnp.float32(jnp.inf), state.hit_t)
    return state.hit_tri, t_out, state.hit_u, state.hit_v
