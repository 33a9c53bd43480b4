"""CPU golden tracer: numpy lockstep driver of the while-while step.

This is BASELINE.json config #1's "CPU traversal golden reference". Every
engine must match its hit ids / t / u / v (SURVEY.md SS5). It shares the
step function (trace/common.py) and all intersection math (ops/) with the
jax drivers, so any divergence is an engine bug, not a formulation drift;
the step machinery itself is validated independently against brute force
(bvh/golden.py).
"""

from __future__ import annotations

import numpy as np

from ntrace_tpu.bvh.flatten import FlatBVH
from ntrace_tpu.bvh.golden import HitRecord
from ntrace_tpu.ops.aabb import safe_inv_dir
from ntrace_tpu.trace.common import any_alive, init_state, traversal_step


def trace_cpu_golden(flat: FlatBVH, orig, dirn, tmin, tmax,
                     any_hit: bool = False, max_steps: int = 1_000_000) -> HitRecord:
    orig = np.asarray(orig, dtype=np.float32)
    dirn = np.asarray(dirn, dtype=np.float32)
    tmin = np.broadcast_to(np.asarray(tmin, dtype=np.float32), orig.shape[:1]).copy()
    tmax = np.broadcast_to(np.asarray(tmax, dtype=np.float32), orig.shape[:1]).copy()
    inv_dir = safe_inv_dir(np, dirn)

    state = init_state(np, orig, tmax)
    steps = 0
    while any_alive(np, state):
        state = traversal_step(
            np, flat.nodes, flat.woop, flat.tri_index,
            orig, dirn, inv_dir, tmin, state, any_hit,
        )
        steps += 1
        if steps > max_steps:
            raise RuntimeError("golden traversal failed to terminate")

    miss = state.hit_tri < 0
    t_out = np.where(miss, np.float32(np.inf), state.hit_t)
    return HitRecord(state.hit_tri, t_out, state.hit_u, state.hit_v)


def golden_mismatches(tri_dev, t_dev, tri_gold, t_gold,
                      ulps: int = 4) -> int:
    """Tie-aware full-frame golden compare (SURVEY.md SS5 image-exact).

    A differing hit id counts as a mismatch only when the hit distances
    also differ by more than `ulps` float32 ulps. Rays crossing a shared
    mesh edge hit two triangles at the same point; engines that visit
    them in a different order than the CPU's BVH walk, or that round
    a*b+c once (FMA) where numpy rounds twice, legitimately return the
    other id with t equal to within 1-2 ulp. Misses (-1 / poison -2)
    never tie.

    The ulp distance is the difference of the int32 bit patterns, exact
    for same-sign finite floats (hit distances are positive).
    """
    tri_dev = np.asarray(tri_dev)
    tri_gold = np.asarray(tri_gold)
    t_dev = np.asarray(t_dev, np.float32)
    t_gold = np.asarray(t_gold, np.float32)
    diff = tri_dev != tri_gold
    both = (tri_dev >= 0) & (tri_gold >= 0)
    fin = np.isfinite(t_dev) & np.isfinite(t_gold)
    bits = np.zeros(tri_dev.shape, np.int64)
    np.subtract(t_dev.view(np.int32).astype(np.int64),
                t_gold.view(np.int32).astype(np.int64), out=bits,
                where=fin)
    tie = both & fin & (np.abs(bits) <= ulps)
    return int((diff & ~tie).sum())
