"""Convex polyhedron clip ops (~ framework/3d/ConvexPolyhedron.*, expected
path, mount empty -- SURVEY.md SS3.1 item "ConvexPolyhedron").

The reference uses a convex polyhedron (camera frustum, clipped
progressively by occluder planes) inside occlusion-aware building. The
rebuild keeps the same capability as a small host-side numpy type:
halfspace representation with lazily maintained vertices, plane clipping
(vertex/edge Sutherland-Hodgman in 3-D), AABB and point containment
tests, and a camera-frustum constructor. Consumers: bvh/occlusion.py's
visibility weighting (optional camera-frustum weights) and tests.

All math is float64 on host (build-time only; never on the device hot path).
"""

from __future__ import annotations

import itertools

import numpy as np

from ntrace_tpu.core import Camera

_EPS = 1e-9


class ConvexPolyhedron:
    """Intersection of halfspaces dot(n, x) <= d, with cached vertices."""

    def __init__(self, normals: np.ndarray, offsets: np.ndarray):
        self.normals = np.asarray(normals, np.float64).reshape(-1, 3)
        self.offsets = np.asarray(offsets, np.float64).reshape(-1)
        self._verts: np.ndarray | None = None

    # -- constructors -----------------------------------------------------

    @staticmethod
    def from_aabb(lo, hi) -> "ConvexPolyhedron":
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        normals = np.vstack([np.eye(3), -np.eye(3)])
        offsets = np.concatenate([hi, -lo])
        return ConvexPolyhedron(normals, offsets)

    @staticmethod
    def camera_frustum(cam: Camera, aspect: float, far: float | None = None
                       ) -> "ConvexPolyhedron":
        """View frustum (4 side planes + near + far) of a pinhole camera."""
        r, u, f = cam.basis()
        r, u, f = (v.astype(np.float64) for v in (r, u, f))
        pos = cam.position.astype(np.float64)
        far = float(far if far is not None else cam.zfar)
        ty = np.tan(np.radians(cam.fov_deg) * 0.5)
        tx = ty * aspect
        # Outward side-plane normals (top, bottom, right, left).
        side = [
            u - ty * f, -(u + ty * f),
            r - tx * f, -(r + tx * f),
        ]
        normals = [s / np.linalg.norm(s) for s in side] + [-f, f]
        offsets = [np.dot(n, pos) for n in normals[:4]]
        offsets += [np.dot(-f, pos) - cam.znear, np.dot(f, pos) + far]
        return ConvexPolyhedron(np.array(normals), np.array(offsets))

    # -- queries ----------------------------------------------------------

    def contains(self, points: np.ndarray, eps: float = 1e-7) -> np.ndarray:
        p = np.asarray(points, np.float64).reshape(-1, 3)
        return ((p @ self.normals.T) <= self.offsets[None, :] + eps).all(
            axis=1)

    def vertices(self) -> np.ndarray:
        """Vertices = feasible intersections of plane triples. (V, 3)."""
        if self._verts is not None:
            return self._verts
        pts = []
        m = len(self.normals)
        for i, j, k in itertools.combinations(range(m), 3):
            a = self.normals[[i, j, k]]
            if abs(np.linalg.det(a)) < _EPS:
                continue
            x = np.linalg.solve(a, self.offsets[[i, j, k]])
            if self.contains(x[None, :], eps=1e-6)[0]:
                pts.append(x)
        if pts:
            v = np.array(pts)
            # dedupe
            key = np.round(v / 1e-7).astype(np.int64)
            _, keep = np.unique(key, axis=0, return_index=True)
            self._verts = v[np.sort(keep)]
        else:
            self._verts = np.zeros((0, 3))
        return self._verts

    def is_empty(self) -> bool:
        return len(self.vertices()) == 0

    def bbox(self) -> tuple[np.ndarray, np.ndarray]:
        v = self.vertices()
        if not len(v):
            z = np.zeros(3)
            return z, z
        return v.min(axis=0), v.max(axis=0)

    def clip(self, normal, offset) -> "ConvexPolyhedron":
        """Intersect with the halfspace dot(normal, x) <= offset."""
        n = np.asarray(normal, np.float64)
        return ConvexPolyhedron(
            np.vstack([self.normals, n[None, :]]),
            np.concatenate([self.offsets, [float(offset)]]),
        )

    def intersects_aabb(self, lo, hi) -> bool:
        """Conservative-exact SAT test vs an AABB (face normals of both).

        Exact for the plane-vs-box direction (the occlusion builder's
        need); the box-vs-polyhedron edge cross terms are skipped, which
        can only report an intersection where there is none -- safe for
        visibility weighting (never culls a visible box).
        """
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        # Each polyhedron plane: is the box entirely outside?
        c = (lo + hi) * 0.5
        e = (hi - lo) * 0.5
        dist = self.normals @ c - self.offsets
        radius = np.abs(self.normals) @ e
        if (dist > radius).any():
            return False
        # Box planes: polyhedron entirely outside?
        v = self.vertices()
        if len(v):
            for ax in range(3):
                if (v[:, ax] < lo[ax] - _EPS).all():
                    return False
                if (v[:, ax] > hi[ax] + _EPS).all():
                    return False
        return True
