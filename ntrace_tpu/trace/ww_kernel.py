"""Per-ray while-while traversal kernel for NVIDIA GPUs (Pallas, Triton route).

This is the reference's own kernel shape (SURVEY.md SS3.3,
~ src/rt/kernels/fermi_speculative_while_while.cu without the speculation):
one lane per ray, a private 64-entry traversal stack, and two inner loops.

  node loop : while any lane of the block sits on an inner node, fetch its
              64-byte node record, slab-test both children (NaN-suppressing
              fmin/fmax, ops/aabb.py), descend near-first and push the far
              child, or pop on a double miss;
  leaf loop : while any lane sits on a leaf run, Woop-test one triangle
              (ops/woop.py) and advance, popping at the 0x80000000 sentinel;
              any-hit rays terminate on their first accepted hit.

A block of BLOCK rays runs these loops under masks; a lane whose ray has
left the current phase idles until the loop ends, as a warp does in the
reference. Every ray takes exactly the step sequence of the lockstep step
machine in trace/common.py, so the results are those of `stack2` and of the
CPU golden tracer (up to the contraction of a*b+c into FMAs, which the GPU
compiler may apply where numpy rounds twice).

Tables are read in the unified layout of trace/unified.py: node rows first,
then one row per Woop triangle with the triangle id's bits in column 12.
The stack lives in a per-ray scratch array laid out (STACK_DEPTH, rays), so
lanes of a warp at the same depth touch consecutive words -- the layout of
CUDA local memory -- and is served from L1 like local memory is.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ntrace_tpu.device import check_kernel_backend
from ntrace_tpu.trace.common import SENTINEL, STACK_DEPTH

_SENT = int(SENTINEL)
_LEAF_END = -0x80000000
_OOEPS = np.float32(np.exp2(-80.0))
_NEG_OOEPS = np.float32(-np.exp2(-80.0))
_ONE = np.float32(1.0)

BLOCK = 64   # rays per block, one lane per ray: two warps


def _safe_inv(d):
    """ops/aabb.py safe_inv_dir, written out for the kernel."""
    g = jnp.where(jnp.abs(d) > _OOEPS, d,
                  jnp.where(d >= 0, _OOEPS, _NEG_OOEPS))
    return _ONE / g


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _ww_kernel(rays_ref, ut_ref, tri_ref, t_ref, u_ref, v_ref, stack_ref, *,
               n_nodes: int, any_hit: bool):
    start = pl.program_id(0) * BLOCK
    lane = start + jnp.arange(BLOCK, dtype=jnp.int32)
    ox, oy, oz, dx, dy, dz, tn, tx = (
        rays_ref[k, pl.ds(start, BLOCK)] for k in range(8))
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    sent = jnp.full((BLOCK,), _SENT, jnp.int32)

    def fetch(row, k, mask):
        return plgpu.load(ut_ref.at[row, k], mask=mask, other=0.0)

    def pop(sp, mask):
        can = mask & (sp > 0)
        slot = jnp.minimum(jnp.maximum(sp - 1, 0), STACK_DEPTH - 1)
        top = plgpu.load(stack_ref.at[slot, lane], mask=can, other=_SENT)
        return jnp.where(can, top, sent), can.astype(jnp.int32)

    def slab(lox, hix, loy, hiy, loz, hiz, ht):
        ax, bx = (lox - ox) * ix, (hix - ox) * ix
        ay, by = (loy - oy) * iy, (hiy - oy) * iy
        az, bz = (loz - oz) * iz, (hiz - oz) * iz
        begin = jnp.fmax(jnp.fmax(jnp.fmin(ax, bx), jnp.fmin(ay, by)),
                         jnp.fmax(jnp.fmin(az, bz), tn))
        end = jnp.fmin(jnp.fmin(jnp.fmax(ax, bx), jnp.fmax(ay, by)),
                       jnp.fmin(jnp.fmax(az, bz), ht))
        return begin <= end, begin

    def node_step(c):
        cur, sp, ht, htri, hu, hv = c
        inner = (cur >= 0) & (cur != _SENT)
        row = jnp.where(inner, cur, 0)
        n = [fetch(row, k, inner) for k in range(14)]
        h0, t0 = slab(n[0], n[1], n[2], n[3], n[8], n[9], ht)
        h1, t1 = slab(n[4], n[5], n[6], n[7], n[10], n[11], ht)
        c0 = jax.lax.bitcast_convert_type(n[12], jnp.int32)
        c1 = jax.lax.bitcast_convert_type(n[13], jnp.int32)
        both = h0 & h1
        neither = ~(h0 | h1)
        near_first = t0 <= t1          # a tie keeps child 0, as in the reference
        near = jnp.where(near_first, c0, c1)
        far = jnp.where(near_first, c1, c0)
        push = inner & both
        plgpu.store(stack_ref.at[jnp.minimum(sp, STACK_DEPTH - 1), lane],
                    far, mask=push)
        popped, popd = pop(sp, inner & neither)
        nxt = jnp.where(neither, popped,
                        jnp.where(both, near, jnp.where(h0, c0, c1)))
        cur = jnp.where(inner, nxt, cur)
        return cur, sp + push.astype(jnp.int32) - popd, ht, htri, hu, hv

    def leaf_step(c):
        cur, sp, ht, htri, hu, hv = c
        leaf = cur < 0
        row = jnp.where(leaf, n_nodes + ~cur, 0)
        w = [fetch(row, k, leaf) for k in range(13)]
        end = jax.lax.bitcast_convert_type(w[0], jnp.int32) == _LEAF_END
        oz_ = w[3] - (ox * w[0] + oy * w[1] + oz * w[2])
        dz_ = dx * w[0] + dy * w[1] + dz * w[2]
        t = oz_ * (_ONE / dz_)
        u = (w[7] + (ox * w[4] + oy * w[5] + oz * w[6])
             ) + t * (dx * w[4] + dy * w[5] + dz * w[6])
        v = (w[11] + (ox * w[8] + oy * w[9] + oz * w[10])
             ) + t * (dx * w[8] + dy * w[9] + dz * w[10])
        valid = (t > tn) & (t < ht) & (u >= 0) & (v >= 0) & (u + v <= _ONE)
        acc = leaf & ~end & valid
        ht = jnp.where(acc, t, ht)
        htri = jnp.where(acc, jax.lax.bitcast_convert_type(w[12], jnp.int32),
                         htri)
        hu = jnp.where(acc, u, hu)
        hv = jnp.where(acc, v, hv)
        popped, popd = pop(sp, leaf & end)
        nxt = jnp.where(end, popped, cur - 1)
        if any_hit:
            nxt = jnp.where(acc, sent, nxt)
        return jnp.where(leaf, nxt, cur), sp - popd, ht, htri, hu, hv

    def while_while(c):
        c = jax.lax.while_loop(
            lambda c: _any((c[0] >= 0) & (c[0] != _SENT)), node_step, c)
        return jax.lax.while_loop(lambda c: _any(c[0] < 0), leaf_step, c)

    zero = jnp.zeros((BLOCK,), jnp.float32)
    init = (jnp.zeros((BLOCK,), jnp.int32), jnp.zeros((BLOCK,), jnp.int32),
            tx, jnp.full((BLOCK,), -1, jnp.int32), zero, zero)
    _, _, ht, htri, hu, hv = jax.lax.while_loop(
        lambda c: _any(c[0] != _SENT), while_while, init)
    out = pl.ds(start, BLOCK)
    tri_ref[out] = htri
    t_ref[out] = jnp.where(htri < 0, jnp.float32(jnp.inf), ht)
    u_ref[out] = hu
    v_ref[out] = hv


@partial(jax.jit, static_argnames=("n_nodes", "any_hit", "interpret"))
def trace_ww(utable, n_nodes, orig, dirn, tmin, tmax, any_hit=False, *,
             interpret=False):
    """Trace rays against a unified table with the while-while kernel.

    Same contract as trace/stack2_jax.py trace_stack2: returns
    (tri, t, u, v) with tri = -1 and t = inf on a miss. The ray count is
    padded to a multiple of BLOCK with rays whose interval is empty.
    interpret=True runs the kernel in the Pallas interpreter (CPU tests);
    it is never chosen for the caller.
    """
    check_kernel_backend(interpret)
    r = orig.shape[0]
    rp = max(-(-r // BLOCK), 1) * BLOCK
    pad = rp - r
    f32 = jnp.float32
    tmin = jnp.broadcast_to(tmin.astype(f32), (r,))
    tmax = jnp.broadcast_to(tmax.astype(f32), (r,))
    rays = jnp.concatenate([orig.astype(f32).T, dirn.astype(f32).T,
                            tmin[None], tmax[None]], axis=0)
    if pad:
        # Padding lanes: tmax < tmin, so the root test fails at once.
        filler = jnp.zeros((8, pad), f32).at[3:6].set(1.0).at[7].set(-1.0)
        rays = jnp.concatenate([rays, filler], axis=1)
    kernel = partial(_ww_kernel, n_nodes=n_nodes, any_hit=any_hit)
    vec = jax.ShapeDtypeStruct((rp,), f32)
    tri, t, u, v, _ = pl.pallas_call(
        kernel,
        grid=(rp // BLOCK,),
        out_shape=(jax.ShapeDtypeStruct((rp,), jnp.int32), vec, vec, vec,
                   jax.ShapeDtypeStruct((STACK_DEPTH, rp), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=BLOCK // 32,
                                             num_stages=1),
        interpret=interpret,
        name="ntrace_while_while",
    )(rays, utable)
    return tri[:r], t[:r], u[:r], v[:r]
