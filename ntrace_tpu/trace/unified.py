"""Unified-table while-while step: ONE gather per ray-step.

The baseline step (trace/common.py) fetches a 64B node record AND a 48B
woop record every step for every ray, though each ray needs only one of
them (its phase). Fusing both tables into one 16-column table and
fetching exactly one row per ray-step cuts gathered traffic ~1.75x and
halves gather launches. The ww kernel (trace/ww_kernel.py) reads the same
table.

Unified table layout (rows are float32[16]):
  row i < n_nodes        : flattened node record (flatten.py layout)
  row n_nodes + j        : woop row j = [m0|m1|m2 (12 floats),
                           bits(tri_index[j]), pad, pad, pad]
The leaf sentinel (m0.x bit pattern 0x80000000) is preserved, so leaf-run
termination logic is unchanged. Traversal state/decisions are IDENTICAL
to the two-table step -- unit tests pin the equivalence.
"""

from __future__ import annotations

import numpy as np

from ntrace_tpu.bvh.flatten import FlatBVH
from ntrace_tpu.ops.aabb import node_slab_test_2
from ntrace_tpu.ops.woop import LEAF_END_BITS, woop_intersect
from ntrace_tpu.trace.common import SENTINEL, STACK_DEPTH, TraceState


def unify_tables(flat: FlatBVH) -> tuple[np.ndarray, int]:
    """FlatBVH -> (unified (N+W, 16) f32 table, n_nodes)."""
    n = flat.nodes.shape[0]
    w = flat.woop.shape[0]
    ut = np.zeros((n + w, 16), dtype=np.float32)
    ut[:n] = flat.nodes
    ut[n:, :12] = flat.woop
    ut[n:, 12] = flat.tri_index.view(np.float32)
    return ut, n


def _bitcast_i32(ns, x):
    if ns is np:
        return np.ascontiguousarray(x).view(np.int32)
    import jax

    return jax.lax.bitcast_convert_type(x, "int32")


def traversal_step_unified(ns, utable, n_nodes, orig, dirn, inv_dir, tmin,
                           state: TraceState, any_hit: bool) -> TraceState:
    """One while-while step with a single unified-table gather."""
    cur, sp, stack = state.cur, state.sp, state.stack
    R = cur.shape[0]
    rows = ns.arange(R)

    alive = cur != SENTINEL
    is_inner = alive & (cur >= 0)
    is_leaf = alive & (cur < 0)

    # ---- the ONE fetch: node record or woop row, by phase ----
    fetch_row = ns.where(is_inner, cur, 0)
    fetch_row = ns.where(is_leaf, n_nodes + (~cur), fetch_row)
    rec = utable[fetch_row]  # (R, 16)

    # ---- inner-node phase (cols 0..13) ----
    hit0, hit1, t0, t1 = node_slab_test_2(ns, rec, orig, inv_dir, tmin, state.hit_t)
    c0 = _bitcast_i32(ns, rec[:, 12])
    c1 = _bitcast_i32(ns, rec[:, 13])
    both = hit0 & hit1
    none_hit = (~hit0) & (~hit1)
    near = ns.where(t0 <= t1, c0, c1)
    far = ns.where(t0 <= t1, c1, c0)
    single = ns.where(hit0, c0, c1)

    # ---- leaf phase (cols 0..12) ----
    w12 = rec[:, :12]
    sent = _bitcast_i32(ns, rec[:, 0]) == LEAF_END_BITS
    tri_here = c0  # col 12 bits = tri_index on woop rows
    valid, t, u, v = woop_intersect(ns, w12, orig, dirn, tmin, state.hit_t)
    accept = is_leaf & (~sent) & valid
    hit_t = ns.where(accept, t, state.hit_t)
    hit_tri = ns.where(accept, tri_here, state.hit_tri)
    hit_u = ns.where(accept, u, state.hit_u)
    hit_v = ns.where(accept, v, state.hit_v)

    # ---- control transitions (identical to trace/common.py) ----
    do_pop = (is_inner & none_hit) | (is_leaf & sent)
    can_pop = sp > 0
    popped = ns.where(
        can_pop, stack[rows, ns.maximum(sp - 1, 0)],
        SENTINEL + ns.zeros_like(cur),
    )
    cur_inner = ns.where(none_hit, popped, ns.where(both, near, single))
    leaf_continue = cur - 1
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
