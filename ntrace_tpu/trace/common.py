"""The while-while traversal step, written once for numpy AND jax.

This is the behavioral contract of the reference's traversal kernels
(SURVEY.md SS3.3, ~ src/rt/kernels/*persistent_while_while*.cu,
fermi_speculative_while_while.cu): per-ray 64-entry traversal stack,
EntrypointSentinel 0x76543210, inner-node phase (fetch 64-byte node,
slab-test both children, descend nearer-first, push farther, pop on miss)
and leaf phase (Woop-test triangles until the 0x80000000 sentinel, shrink
hitT on accepted hits, any-hit early out).

Instead of one CUDA thread per ray, every ray in the batch executes ONE step
of the state machine per iteration in lockstep (vector ops over (R,)-shaped
state) -- the XLA moral equivalent of a warp, and exactly replayable
in numpy for the golden tracer. All arithmetic is delegated to ops/ so both
drivers share one formulation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from ntrace_tpu.ops.aabb import node_slab_test_2
from ntrace_tpu.ops.woop import woop_intersect, LEAF_END_BITS

SENTINEL = np.int32(0x76543210)  # EntrypointSentinel of the reference
STACK_DEPTH = 64


@dataclass
class TraceState:
    """Per-ray traversal state (R,)-shaped arrays; a pytree in the jax driver."""

    cur: Any       # int32 current node (>=0 inner, <0 ~woopRow, SENTINEL done)
    sp: Any        # int32 stack pointer
    stack: Any     # (R, STACK_DEPTH) int32
    hit_t: Any     # float32 current hitT (init ray tmax)
    hit_tri: Any   # int32 (-1 miss)
    hit_u: Any     # float32
    hit_v: Any     # float32


def _bitcast_i32(ns, x):
    if ns is np:
        return np.ascontiguousarray(x).view(np.int32)
    import jax

    return jax.lax.bitcast_convert_type(x, "int32")


def init_state(ns, orig, tmax):
    r = orig.shape[0]
    i32 = np.int32 if ns is np else "int32"
    f32 = np.float32 if ns is np else "float32"
    return TraceState(
        cur=ns.zeros((r,), dtype=i32),
        sp=ns.zeros((r,), dtype=i32),
        stack=ns.full((r, STACK_DEPTH), SENTINEL, dtype=i32),
        hit_t=ns.asarray(tmax, dtype=f32) + ns.zeros((r,), dtype=f32),
        hit_tri=ns.full((r,), -1, dtype=i32),
        hit_u=ns.zeros((r,), dtype=f32),
        hit_v=ns.zeros((r,), dtype=f32),
    )


def traversal_step(ns, nodes, woop, tri_index, orig, dirn, inv_dir, tmin,
                   state: TraceState, any_hit: bool) -> TraceState:
    """Advance every ray by one while-while step. Pure function of state."""
    cur, sp, stack = state.cur, state.sp, state.stack
    R = cur.shape[0]
    rows = ns.arange(R)

    alive = cur != SENTINEL
    is_inner = alive & (cur >= 0)
    is_leaf = alive & (cur < 0)

    # ---------------- inner-node phase ----------------
    ni = ns.where(is_inner, cur, 0)
    node16 = nodes[ni]
    hit0, hit1, t0, t1 = node_slab_test_2(
        ns, node16, orig, inv_dir, tmin, state.hit_t
    )
    c0 = _bitcast_i32(ns, node16[:, 12])
    c1 = _bitcast_i32(ns, node16[:, 13])
    both = hit0 & hit1
    none_hit = (~hit0) & (~hit1)
    near = ns.where(t0 <= t1, c0, c1)  # tie keeps child0, as in the reference
    far = ns.where(t0 <= t1, c1, c0)
    single = ns.where(hit0, c0, c1)

    # ---------------- leaf phase ----------------
    row = ns.where(is_leaf, ~cur, 0)
    w12 = woop[row]
    sent = _bitcast_i32(ns, w12[:, 0]) == LEAF_END_BITS
    valid, t, u, v = woop_intersect(ns, w12, orig, dirn, tmin, state.hit_t)
    accept = is_leaf & (~sent) & valid
    hit_t = ns.where(accept, t, state.hit_t)
    hit_tri = ns.where(accept, tri_index[row], state.hit_tri)
    hit_u = ns.where(accept, u, state.hit_u)
    hit_v = ns.where(accept, v, state.hit_v)

    # ---------------- control transitions ----------------
    do_pop = (is_inner & none_hit) | (is_leaf & sent)
    can_pop = sp > 0
    popped = ns.where(
        can_pop, stack[rows, ns.maximum(sp - 1, 0)], SENTINEL.astype(np.int32) + ns.zeros_like(cur)
    )

    cur_inner = ns.where(none_hit, popped, ns.where(both, near, single))
    leaf_continue = cur - 1  # cur == ~row, so ~(row+1) == cur - 1
    cur_leaf = ns.where(sent, popped, leaf_continue)
    if any_hit:
        cur_leaf = ns.where(accept, SENTINEL + ns.zeros_like(cur), cur_leaf)

    new_cur = ns.where(is_inner, cur_inner, ns.where(is_leaf, cur_leaf, cur))

    push = is_inner & both
    new_sp = sp + push.astype(sp.dtype) - (do_pop & can_pop).astype(sp.dtype)
    slot = ns.minimum(sp, STACK_DEPTH - 1)
    if ns is np:
        new_stack = stack.copy()
        m = np.asarray(push)
        new_stack[rows[m], slot[m]] = far[m]
    else:
        # Drop-mode scatter avoids the read-modify-write row gather.
        oslot = ns.where(push, slot, STACK_DEPTH)
        new_stack = stack.at[rows, oslot].set(far, mode="drop")

    return TraceState(
        cur=new_cur, sp=new_sp, stack=new_stack,
        hit_t=hit_t, hit_tri=hit_tri, hit_u=hit_u, hit_v=hit_v,
    )


def any_alive(ns, state: TraceState):
    return ns.any(state.cur != SENTINEL)
