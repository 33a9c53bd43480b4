"""Unit tests for ops/: Morton codes, slab test edge cases, Woop transform."""

import numpy as np
import pytest

from ntrace_tpu.ops import aabb, morton
from ntrace_tpu.ops.intersect import moller_trumbore
from ntrace_tpu.ops.woop import woop_intersect, woopify


class TestMorton:
    def test_morton3d_matches_scalar_reference(self):
        rng = np.random.default_rng(0)
        xyz = rng.integers(0, 1024, size=(256, 3))
        got = morton.morton3d(np, xyz[:, 0], xyz[:, 1], xyz[:, 2])
        want = [morton.morton3d_ref_scalar(*map(int, p)) for p in xyz]
        np.testing.assert_array_equal(got, np.asarray(want, dtype=np.int32))

    def test_morton3d_jax_matches_numpy(self):
        import jax.numpy as jnp

        rng = np.random.default_rng(1)
        xyz = rng.integers(0, 1024, size=(128, 3)).astype(np.int32)
        a = morton.morton3d(np, xyz[:, 0], xyz[:, 1], xyz[:, 2])
        b = morton.morton3d(jnp, jnp.asarray(xyz[:, 0]), jnp.asarray(xyz[:, 1]), jnp.asarray(xyz[:, 2]))
        np.testing.assert_array_equal(a, np.asarray(b))

    def test_morton2d_matches_scalar_reference(self):
        rng = np.random.default_rng(2)
        xy = rng.integers(0, 65536, size=(128, 2))
        got = morton.morton2d(np, xy[:, 0], xy[:, 1])
        want = [morton.morton2d_ref_scalar(int(x), int(y)) for x, y in xy]
        np.testing.assert_array_equal(got, np.asarray(want, dtype=np.int64))

    def test_morton_codes_ordering_is_spatial(self):
        # Points along x must produce nondecreasing codes once y/z are fixed.
        pts = np.stack([np.linspace(0, 1, 64), np.zeros(64), np.zeros(64)], axis=1).astype(np.float32)
        codes = morton.morton_codes_3d(np, pts, np.zeros(3, np.float32), np.ones(3, np.float32))
        assert (np.diff(codes) >= 0).all()


class TestSlab:
    def test_basic_hit_miss(self):
        lo = np.array([[0, 0, 0]], np.float32)
        hi = np.array([[1, 1, 1]], np.float32)
        o = np.array([[0.5, 0.5, -1.0]], np.float32)
        d = np.array([[0.0, 0.0, 1.0]], np.float32)
        inv = aabb.safe_inv_dir(np, d)
        hit, t = aabb.slab_test(np, lo, hi, o, inv, np.float32(0), np.float32(1e9))
        assert hit[0] and abs(t[0] - 1.0) < 1e-6
        o2 = np.array([[2.5, 0.5, -1.0]], np.float32)
        hit2, _ = aabb.slab_test(np, lo, hi, o2, inv, np.float32(0), np.float32(1e9))
        assert not hit2[0]

    def test_ray_parallel_to_slab_on_boundary(self):
        # Origin exactly on a slab plane with zero direction component:
        # (lo-o)*inf = 0*inf = NaN; fmin/fmax must suppress it (CUDA fminf).
        lo = np.array([[0, 0, 0]], np.float32)
        hi = np.array([[1, 1, 1]], np.float32)
        o = np.array([[0.0, 0.5, -1.0]], np.float32)  # on x=lo plane
        d = np.array([[0.0, 0.0, 1.0]], np.float32)
        inv = aabb.safe_inv_dir(np, d)
        hit, _ = aabb.slab_test(np, lo, hi, o, inv, np.float32(0), np.float32(1e9))
        assert hit[0]

    def test_inverted_direction(self):
        lo = np.array([[0, 0, 0]], np.float32)
        hi = np.array([[1, 1, 1]], np.float32)
        o = np.array([[0.5, 0.5, 2.0]], np.float32)
        d = np.array([[0.0, 0.0, -1.0]], np.float32)
        inv = aabb.safe_inv_dir(np, d)
        hit, t = aabb.slab_test(np, lo, hi, o, inv, np.float32(0), np.float32(1e9))
        assert hit[0] and abs(t[0] - 1.0) < 1e-6

    def test_node_slab_test_2_agrees_with_single(self):
        rng = np.random.default_rng(3)
        n = 256
        lo0 = rng.uniform(-5, 0, (n, 3)).astype(np.float32)
        hi0 = lo0 + rng.uniform(0.1, 5, (n, 3)).astype(np.float32)
        lo1 = rng.uniform(-5, 0, (n, 3)).astype(np.float32)
        hi1 = lo1 + rng.uniform(0.1, 5, (n, 3)).astype(np.float32)
        node = np.zeros((n, 16), np.float32)
        node[:, 0], node[:, 1], node[:, 2], node[:, 3] = lo0[:, 0], hi0[:, 0], lo0[:, 1], hi0[:, 1]
        node[:, 4], node[:, 5], node[:, 6], node[:, 7] = lo1[:, 0], hi1[:, 0], lo1[:, 1], hi1[:, 1]
        node[:, 8], node[:, 9], node[:, 10], node[:, 11] = lo0[:, 2], hi0[:, 2], lo1[:, 2], hi1[:, 2]
        o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        inv = aabb.safe_inv_dir(np, d)
        tmin = np.zeros(n, np.float32)
        tmax = np.full(n, 1e9, np.float32)
        h0, h1, t0, t1 = aabb.node_slab_test_2(np, node, o, inv, tmin, tmax)
        s0, st0 = aabb.slab_test(np, lo0, hi0, o, inv, tmin, tmax)
        s1, st1 = aabb.slab_test(np, lo1, hi1, o, inv, tmin, tmax)
        np.testing.assert_array_equal(h0, s0)
        np.testing.assert_array_equal(h1, s1)
        np.testing.assert_allclose(t0[h0], st0[s0], rtol=0, atol=0)
        np.testing.assert_allclose(t1[h1], st1[s1], rtol=0, atol=0)


class TestWoop:
    def _random_tris_and_rays(self, n, seed=0):
        rng = np.random.default_rng(seed)
        tv = rng.uniform(-2, 2, size=(n, 3, 3)).astype(np.float32)
        o = rng.uniform(-4, 4, size=(n, 3)).astype(np.float32)
        # Aim at a point inside each triangle so ~half the rays hit.
        w = rng.dirichlet([1, 1, 1], size=n).astype(np.float32)
        target = np.einsum("nk,nkj->nj", w, tv)
        jitter = rng.normal(scale=0.8, size=(n, 3)).astype(np.float32)
        d = target + jitter * (rng.random((n, 1)) < 0.5) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return tv, o, d.astype(np.float32)

    def test_woop_matches_moller_trumbore(self):
        tv, o, d = self._random_tris_and_rays(4096, seed=5)
        tmin = np.zeros(len(o), np.float32)
        tmax = np.full(len(o), 1e9, np.float32)
        w12 = woopify(tv)
        wv, wt, wu, wvv = woop_intersect(np, w12, o, d, tmin, tmax)
        mv, mt, mu, mvv2 = moller_trumbore(np, o, d, tv[:, 0], tv[:, 1], tv[:, 2], tmin, tmax)
        # Hit/miss agreement except borderline epsilon cases.
        disagree = wv != mv
        assert disagree.mean() < 0.002, f"{disagree.sum()} hit/miss disagreements"
        both = wv & mv
        assert both.sum() > 100  # sanity: the test actually exercises hits
        np.testing.assert_allclose(wt[both], mt[both], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(wu[both], mu[both], rtol=0, atol=2e-3)
        np.testing.assert_allclose(wvv[both], mvv2[both], rtol=0, atol=2e-3)

    def test_barycentric_interpolation_recovers_hit_point(self):
        tv, o, d = self._random_tris_and_rays(2048, seed=6)
        tmin = np.zeros(len(o), np.float32)
        tmax = np.full(len(o), 1e9, np.float32)
        w12 = woopify(tv)
        wv, wt, wu, wvv = woop_intersect(np, w12, o, d, tmin, tmax)
        hitp = o + wt[:, None] * d
        interp = (
            (1 - wu - wvv)[:, None] * tv[:, 0]
            + wu[:, None] * tv[:, 1]
            + wvv[:, None] * tv[:, 2]
        )
        err = np.linalg.norm(hitp[wv] - interp[wv], axis=1)
        assert err.max() < 1e-3

    def test_degenerate_triangle_never_hits(self):
        tv = np.zeros((4, 3, 3), np.float32)
        tv[0] = [[0, 0, 0], [1, 1, 1], [2, 2, 2]]  # collinear
        tv[1] = [[1, 2, 3], [1, 2, 3], [1, 2, 3]]  # a point
        tv[2] = [[0, 0, 0], [1, 0, 0], [2, 0, 0]]  # collinear on axis
        tv[3] = [[0, 0, 0], [1, 0, 0], [0.5, 0, 0]]
        w12 = woopify(tv)
        rng = np.random.default_rng(7)
        o = rng.uniform(-5, 5, size=(64, 3)).astype(np.float32)
        d = rng.normal(size=(64, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        for k in range(4):
            wv, *_ = woop_intersect(
                np, np.broadcast_to(w12[k], (64, 12)), o, d,
                np.zeros(64, np.float32), np.full(64, 1e9, np.float32),
            )
            assert not wv.any()

    def test_parallel_ray_misses(self):
        tv = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
        w12 = woopify(tv)
        o = np.array([[0.2, 0.2, 1.0]], np.float32)
        d = np.array([[1.0, 0.0, 0.0]], np.float32)  # parallel to tri plane
        wv, *_ = woop_intersect(np, w12, o, d, np.zeros(1, np.float32), np.full(1, 1e9, np.float32))
        assert not wv[0]

    def test_jax_woop_matches_numpy(self):
        import jax.numpy as jnp

        tv, o, d = self._random_tris_and_rays(512, seed=8)
        tmin = np.zeros(len(o), np.float32)
        tmax = np.full(len(o), 1e9, np.float32)
        w12 = woopify(tv)
        nv, nt, nu, nvv = woop_intersect(np, w12, o, d, tmin, tmax)
        jv, jt, ju, jvv = woop_intersect(jnp, jnp.asarray(w12), jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
        np.testing.assert_array_equal(nv, np.asarray(jv))
        np.testing.assert_allclose(nt[nv], np.asarray(jt)[nv], rtol=1e-6)


class TestBlockedScan:
    """ops/scan.py blocked prefix scans vs numpy accumulate."""

    def test_matches_numpy_accumulate(self):
        import jax.numpy as jnp

        from ntrace_tpu.ops.scan import cummax_blocked, cummin_blocked

        rng = np.random.default_rng(0)
        for n in (1, 5, 128, 300, 1000, 40001):
            x = rng.integers(-10**9, 10**9, n).astype(np.int32)
            for shape in [(n,), (3, n)]:
                ref = np.broadcast_to(x, shape)
                a = jnp.asarray(ref)
                np.testing.assert_array_equal(
                    np.asarray(cummax_blocked(a)),
                    np.maximum.accumulate(ref, -1))
                np.testing.assert_array_equal(
                    np.asarray(cummin_blocked(a)),
                    np.minimum.accumulate(ref, -1))
                np.testing.assert_array_equal(
                    np.asarray(cummax_blocked(a, reverse=True)),
                    np.maximum.accumulate(ref[..., ::-1], -1)[..., ::-1])
                np.testing.assert_array_equal(
                    np.asarray(cummin_blocked(a, reverse=True)),
                    np.minimum.accumulate(ref[..., ::-1], -1)[..., ::-1])


class TestConvexPolyhedron:
    """~ framework/3d/ConvexPolyhedron.* clip ops."""

    def test_aabb_roundtrip(self):
        from ntrace_tpu.ops.polyhedron import ConvexPolyhedron

        p = ConvexPolyhedron.from_aabb([0, 0, 0], [2, 3, 4])
        lo, hi = p.bbox()
        np.testing.assert_allclose(lo, [0, 0, 0], atol=1e-9)
        np.testing.assert_allclose(hi, [2, 3, 4], atol=1e-9)
        assert p.contains(np.array([[1, 1, 1]]))[0]
        assert not p.contains(np.array([[3, 1, 1]]))[0]

    def test_clip_halves_box(self):
        from ntrace_tpu.ops.polyhedron import ConvexPolyhedron

        p = ConvexPolyhedron.from_aabb([0, 0, 0], [2, 2, 2])
        q = p.clip([1, 0, 0], 1.0)  # keep x <= 1
        lo, hi = q.bbox()
        np.testing.assert_allclose(hi[0], 1.0, atol=1e-9)
        r = q.clip([1, 0, 0], -1.0)  # x <= -1: empty
        assert r.is_empty()

    def test_camera_frustum(self):
        from ntrace_tpu.core import Camera
        from ntrace_tpu.ops.polyhedron import ConvexPolyhedron

        cam = Camera(position=[0, 0, 0], forward=[0, 0, -1], fov_deg=90.0,
                     znear=0.1, zfar=100.0)
        fr = ConvexPolyhedron.camera_frustum(cam, aspect=1.0)
        assert fr.contains(np.array([[0, 0, -10]]))[0]       # straight ahead
        assert not fr.contains(np.array([[0, 0, 10]]))[0]    # behind
        assert not fr.contains(np.array([[50, 0, -10]]))[0]  # off to the side
        assert fr.contains(np.array([[9, 9, -10.1]]))[0]     # inside corner
        # AABB tests: visible box intersects, behind-camera box does not.
        assert fr.intersects_aabb([-1, -1, -5], [1, 1, -4])
        assert not fr.intersects_aabb([-1, -1, 4], [1, 1, 5])
