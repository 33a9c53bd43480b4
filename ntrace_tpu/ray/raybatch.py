"""RayBatch pytree + Morton re-sort of secondary rays.

Reference parity (~ rt/ray/RayBuffer.{cpp,hpp} + RayBufferKernels.cu):
  - SoA ray storage: origin/tmin, direction/tmax per ray
  - results: (id, t, u, v)
  - slot<->id remap tables so sorted traversal order can be unsorted back
  - `mortonSort`: re-sort incoherent secondary rays by a key interleaving
    quantized origin (high bits) and direction octant (low bits) so nearby
    rays traverse nearby nodes
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ntrace_tpu.ops.morton import morton_codes_3d


@dataclass
class RayBatch:
    orig: Any  # (R, 3) f32
    dirn: Any  # (R, 3) f32
    tmin: Any  # (R,) f32
    tmax: Any  # (R,) f32
    slot_to_id: Any = None  # (R,) i32: original ray id of each slot

    @property
    def num_rays(self) -> int:
        return int(self.orig.shape[0])


jax.tree_util.register_pytree_node(
    RayBatch,
    lambda b: ((b.orig, b.dirn, b.tmin, b.tmax, b.slot_to_id), None),
    lambda _, c: RayBatch(*c),
)


def _direction_octant(ns, dirn):
    """3-bit direction octant code (sign bits of x, y, z)."""
    return (
        (dirn[..., 0] < 0).astype("int32") * 4
        + (dirn[..., 1] < 0).astype("int32") * 2
        + (dirn[..., 2] < 0).astype("int32")
    )


def morton_sort_key(ns, orig, dirn, scene_lo, scene_hi,
                    direction_major: bool = True):
    """Coherence sort key for ray reordering.

    direction_major=True: 6-bit direction code (2 bits/axis, interleaved)
    before the origin Morton code. For LONG incoherent rays (diffuse/path
    bounces) the dominant coherence axis is DIRECTION: rays traced side
    by side then want the same nodes. (Chosen for an earlier packet
    engine, where finer direction codes (9/12 bits) lost origin
    coherence; not yet measured on a GPU.)

    direction_major=False: origin-major with the direction octant in the
    low bits -- the right key for SHORT rays (AO at ao_radius tmax),
    whose node unions are local to the origin; direction-major measured
    2x SLOWER there (fairy AO 52 -> 24 Mrays/s).

    Fits int32 (no x64 dependency); the reference's exact (origin,
    direction) bit budget is unverifiable (empty mount).
    """
    oc = morton_codes_3d(ns, orig, scene_lo, scene_hi)
    if not direction_major:
        return (oc & ~np.int32(7)) | _direction_octant(ns, dirn)
    n2 = ns.clip(
        ((dirn / ns.maximum(
            ns.linalg.norm(dirn, axis=-1, keepdims=True), 1e-30)
          + 1.0) * 2.0).astype("int32"), 0, 3)
    dir6 = ns.zeros_like(oc)
    for b in range(2):
        dir6 = (dir6
                | ((n2[..., 0] >> b) & 1) << (3 * b + 2)
                | ((n2[..., 1] >> b) & 1) << (3 * b + 1)
                | ((n2[..., 2] >> b) & 1) << (3 * b + 0))
    return (dir6 << 25) | (oc >> 5)


def morton_sort_rays(batch: RayBatch, scene_lo, scene_hi,
                     direction_major: bool = True) -> RayBatch:
    """Return a new RayBatch sorted for coherence, tracking slot_to_id.

    direction_major: see morton_sort_key -- True for long bounce rays,
    False for short (AO-class) rays. Dead rays (tmax <= tmin: padding,
    already-terminated) sort to the END so they fill whole blocks that
    exit at once instead of wasting lanes inside live blocks.
    """
    ns = jnp if isinstance(batch.orig, jax.Array) else np
    key = morton_sort_key(ns, batch.orig, batch.dirn, scene_lo, scene_hi,
                          direction_major=direction_major)
    key = ns.where(batch.tmax <= batch.tmin, np.int32(0x7FFFFFFF), key)
    order = ns.argsort(key)
    ids = batch.slot_to_id
    if ids is None:
        ids = ns.arange(batch.num_rays, dtype="int32")
    return RayBatch(
        orig=batch.orig[order],
        dirn=batch.dirn[order],
        tmin=batch.tmin[order],
        tmax=batch.tmax[order],
        slot_to_id=ids[order],
    )


def unsort(values, slot_to_id, num_rays=None):
    """Scatter per-slot values back to original ray-id order."""
    ns = jnp if isinstance(values, jax.Array) else np
    n = num_rays or values.shape[0]
    if ns is np:
        out = np.empty((n,) + values.shape[1:], dtype=values.dtype)
        out[slot_to_id] = values
        return out
    out = jnp.zeros((n,) + values.shape[1:], dtype=values.dtype)
    return out.at[slot_to_id].set(values)
