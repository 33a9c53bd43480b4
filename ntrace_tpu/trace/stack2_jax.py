"""Engine v2: unified-table lockstep traversal with macro-stepping.

Two optimizations over trace/stack_jax.py (not yet tuned for a GPU):
  1. unified node+woop table -> ONE gather per ray-step (1.75x less
     gathered traffic, half the gather launches);
  2. UNROLL steps per while_loop iteration (macro-stepping amortizes loop
     overhead and lets XLA software-pipeline).
Results are bit-identical in decision sequence to the v1 engine (rays
that finish inside a macro-step idle behind their SENTINEL masks).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ntrace_tpu.ops.aabb import safe_inv_dir
from ntrace_tpu.trace import common
from ntrace_tpu.trace import stack_jax  # noqa: F401  (registers TraceState pytree)
from ntrace_tpu.trace.common import init_state
from ntrace_tpu.trace.unified import traversal_step_unified


@partial(jax.jit, static_argnames=("n_nodes", "any_hit", "unroll"))
def trace_stack2(utable, n_nodes, orig, dirn, tmin, tmax,
                 any_hit=False, unroll=8):
    """Trace a ray batch against a unified table (see trace/unified.py)."""
    orig = orig.astype(jnp.float32)
    dirn = dirn.astype(jnp.float32)
    tmin = jnp.broadcast_to(tmin.astype(jnp.float32), orig.shape[:1])
    tmax = jnp.broadcast_to(tmax.astype(jnp.float32), orig.shape[:1])
    inv_dir = safe_inv_dir(jnp, dirn)

    state = init_state(jnp, orig, tmax)

    def cond(s):
        return common.any_alive(jnp, s)

    def body(s):
        for _ in range(unroll):
            s = traversal_step_unified(
                jnp, utable, n_nodes, orig, dirn, inv_dir, tmin, s, any_hit
            )
        return s

    state = jax.lax.while_loop(cond, body, state)
    miss = state.hit_tri < 0
    t_out = jnp.where(miss, jnp.float32(jnp.inf), state.hit_t)
    return state.hit_tri, t_out, state.hit_u, state.hit_v
