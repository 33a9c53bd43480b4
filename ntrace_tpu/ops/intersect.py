"""Ray-triangle intersection: Moller-Trumbore (plain-vertex path).

Moller-Trumbore is the reference's CPU-side / validation intersector; the GPU
kernels use the Woop unit-triangle test (ops/woop.py). Both are exposed here
with one namespace-generic formulation so golden and device paths agree.

Conventions shared by every intersector in this framework:
  - a hit counts iff tmin < t < tmax (strict, matching the reference kernel's
    `if (t > tmin && t < hitT)` update rule, expected
    src/rt/kernels/CudaTracerKernels.hpp)
  - barycentrics (u, v) are weights of vertices 1 and 2
  - closest-hit ties (equal t) break toward the LOWEST triangle index; this
    deterministic tie-break is a rebuild addition enabling image-exact tests
"""

from __future__ import annotations

import numpy as np


def moller_trumbore(ns, orig, dirn, v0, v1, v2, tmin, tmax):
    """Batched Moller-Trumbore.

    orig, dirn : (..., 3) rays
    v0,v1,v2   : (..., 3) triangle vertices (broadcastable against rays)
    tmin, tmax : (...)

    Returns (valid, t, u, v). Invalid lanes have undefined t/u/v -- mask them.
    Non-culling (hits both faces). Degenerate triangles (det==0) miss.
    """
    one = np.float32(1.0)
    e1 = v1 - v0
    e2 = v2 - v0
    # pvec = dir x e2
    px = dirn[..., 1] * e2[..., 2] - dirn[..., 2] * e2[..., 1]
    py = dirn[..., 2] * e2[..., 0] - dirn[..., 0] * e2[..., 2]
    pz = dirn[..., 0] * e2[..., 1] - dirn[..., 1] * e2[..., 0]
    det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    # Guard the reciprocal; det==0 lanes are rejected by the mask below.
    inv_det = one / ns.where(det == 0, np.float32(1.0), det)
    tx = orig[..., 0] - v0[..., 0]
    ty = orig[..., 1] - v0[..., 1]
    tz = orig[..., 2] - v0[..., 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1[..., 2] - tz * e1[..., 1]
    qy = tz * e1[..., 0] - tx * e1[..., 2]
    qz = tx * e1[..., 1] - ty * e1[..., 0]
    v = (dirn[..., 0] * qx + dirn[..., 1] * qy + dirn[..., 2] * qz) * inv_det
    t = (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz) * inv_det
    valid = (
        (det != 0)
        & (u >= 0)
        & (v >= 0)
        & (u + v <= one)
        & (t > tmin)
        & (t < tmax)
    )
    return valid, t, u, v
