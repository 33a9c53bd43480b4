"""Persistent-dispatch tracer: the whole frame in ONE device launch.

The reference's persistent-threads kernels exist to avoid per-batch launch
overhead; the analogue for a lockstep XLA engine is dispatch count, not
warp scheduling. This driver reshapes the frame into (n_chunks, chunk) and runs the
per-chunk while-while loop under `lax.map` INSIDE one jit call -- one
dispatch per frame, chunks still small enough that lockstep tail waste
stays bounded (Morton pixel order keeps chunks coherent).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ntrace_tpu.ops.aabb import safe_inv_dir
from ntrace_tpu.trace import common
from ntrace_tpu.trace import stack_jax  # noqa: F401  (TraceState pytree reg.)
from ntrace_tpu.trace.common import init_state
from ntrace_tpu.trace.unified import traversal_step_unified


@partial(jax.jit, static_argnames=("n_nodes", "any_hit", "unroll", "chunk"))
def trace_persistent(utable, n_nodes, orig, dirn, tmin, tmax,
                     any_hit=False, unroll=8, chunk=1 << 15):
    """One-dispatch frame trace. Ray count must be a chunk multiple
    (renderer pads with tmax=0 rays, which terminate on their first step).
    """
    r = orig.shape[0]
    assert r % chunk == 0, "pad rays to a chunk multiple"
    c = r // chunk

    orig = orig.astype(jnp.float32).reshape(c, chunk, 3)
    dirn = dirn.astype(jnp.float32).reshape(c, chunk, 3)
    tmin = jnp.broadcast_to(tmin.astype(jnp.float32), (r,)).reshape(c, chunk)
    tmax = jnp.broadcast_to(tmax.astype(jnp.float32), (r,)).reshape(c, chunk)

    def one_chunk(args):
        o, d, tn, tx = args
        inv = safe_inv_dir(jnp, d)
        state = init_state(jnp, o, tx)

        def cond(s):
            return common.any_alive(jnp, s)

        def body(s):
            for _ in range(unroll):
                s = traversal_step_unified(
                    jnp, utable, n_nodes, o, d, inv, tn, s, any_hit
                )
            return s

        s = jax.lax.while_loop(cond, body, state)
        miss = s.hit_tri < 0
        return (s.hit_tri, jnp.where(miss, jnp.float32(jnp.inf), s.hit_t),
                s.hit_u, s.hit_v)

    tri, t, u, v = jax.lax.map(one_chunk, (orig, dirn, tmin, tmax))
    return tri.reshape(r), t.reshape(r), u.reshape(r), v.reshape(r)
