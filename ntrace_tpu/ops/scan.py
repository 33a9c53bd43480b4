"""Blocked prefix scans along the last axis (128-lane blocks).

The idea: XLA lowers `lax.cummax` on a length-n axis as ~log2(n)
shifted-op passes over the full array (~20 passes at 1M); the blocked
form does 7 in-lane passes over 128-wide blocks, recursively scans the
block carries (a 128x smaller problem), and applies the carry in one
combine pass -- ~8 full-size passes total.

A recorded negative result: in the (31, n) ANSV scans of bvh/lbvh.py it
was slower than plain lax.cummax/cummin, which bvh/lbvh.py uses. Kept (with CPU-verified correctness) for shapes where
the native scan is pathological; not measured on a GPU.

Reference context: replaces the running-max/min bookkeeping a CUDA builder
would do with warp scans + atomics (expected rt/bvh/HLBVH/*, SURVEY.md
SS3.2; mount empty).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_BLK = 128


def _scan_lane(x, op, reverse):
    """In-lane scan of (..., B, 128) along the last axis."""
    k = x.shape[-1]
    s = 1
    while s < k:
        if reverse:
            shifted = jnp.concatenate(
                [x[..., s:], x[..., -s:]], axis=-1)
            # pad tail with identity: reuse self then mask via where
            lane = jnp.arange(k)
            shifted = jnp.where(lane < k - s, shifted, x)
            x = jnp.where(lane < k - s, op(x, shifted), x)
        else:
            shifted = jnp.concatenate([x[..., :s], x[..., :-s]], axis=-1)
            lane = jnp.arange(k)
            x = jnp.where(lane >= s, op(x, shifted), x)
        s *= 2
    return x


def blocked_scan(x, op, identity, reverse: bool = False):
    """Inclusive scan of `x` (..., n) along the last axis with `op`."""
    n = x.shape[-1]
    if n <= _BLK:
        return _scan_lane(x, op, reverse)
    b = -(-n // _BLK)
    pad = b * _BLK - n
    if pad:
        padv = jnp.full(x.shape[:-1] + (pad,), identity, x.dtype)
        x = jnp.concatenate(
            [padv, x] if reverse else [x, padv], axis=-1)
    m = x.reshape(x.shape[:-1] + (b, _BLK))
    m = _scan_lane(m, op, reverse)
    carry_in = m[..., 0] if reverse else m[..., -1]      # (..., b)
    carry = blocked_scan(carry_in, op, identity, reverse)
    if reverse:
        carry = jnp.concatenate(
            [carry[..., 1:],
             jnp.full(carry.shape[:-1] + (1,), identity, x.dtype)],
            axis=-1)
    else:
        carry = jnp.concatenate(
            [jnp.full(carry.shape[:-1] + (1,), identity, x.dtype),
             carry[..., :-1]], axis=-1)
    m = op(m, carry[..., None])
    out = m.reshape(x.shape[:-1] + (b * _BLK,))
    if pad:
        out = out[..., pad:] if reverse else out[..., :n]
    return out


def cummax_blocked(x, reverse: bool = False):
    info = np.iinfo(x.dtype) if jnp.issubdtype(x.dtype, jnp.integer) else None
    ident = info.min if info else -np.inf
    return blocked_scan(x, jnp.maximum, ident, reverse)


def cummin_blocked(x, reverse: bool = False):
    info = np.iinfo(x.dtype) if jnp.issubdtype(x.dtype, jnp.integer) else None
    ident = info.max if info else np.inf
    return blocked_scan(x, jnp.minimum, ident, reverse)
