"""kd-tree builder + interval-stack traversal vs brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

from ntrace_tpu.bvh.golden import brute_force_anyhit, brute_force_mt
from ntrace_tpu.bvh.kdtree import build_kdtree
from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.scenes import get_scene, make_random_soup, make_two_quads
from ntrace_tpu.trace.kdtree_jax import trace_kd
from ntrace_tpu.trace.unified import unify_tables
from tests.conftest import random_rays
from tests.test_bvh import assert_hits_match_brute


def _trace(scene, o, d, tmin, tmax, any_hit=False, chunk=256, cfg=None):
    kd = build_kdtree(scene, cfg or BuildConfig())
    ut, n_nodes = unify_tables(kd)
    r = o.shape[0]
    pad = (-r) % chunk
    if pad:
        o = np.concatenate([o, np.zeros((pad, 3), np.float32)])
        d = np.concatenate([d, np.ones((pad, 3), np.float32)])
        tmin = np.concatenate([tmin, np.zeros((pad,), np.float32)])
        tmax = np.concatenate([tmax, np.zeros((pad,), np.float32)])
    out = trace_kd(jnp.asarray(ut), n_nodes, jnp.asarray(kd.root_lo),
                   jnp.asarray(kd.root_hi), jnp.asarray(o), jnp.asarray(d),
                   jnp.asarray(tmin), jnp.asarray(tmax),
                   any_hit=any_hit, chunk=chunk)
    return tuple(np.asarray(x)[:r] for x in out)


class TestKDTree:
    @pytest.mark.parametrize("n_tris,seed", [(500, 7), (3000, 21)])
    def test_matches_brute_force(self, rng, n_tris, seed):
        scene = make_random_soup(n_tris=n_tris, seed=seed)
        o, d, tmin, tmax = random_rays(rng, 1200)
        tri, t, u, v = _trace(scene, o, d, tmin, tmax)
        brute = brute_force_mt(scene, o, d, tmin, tmax)
        from ntrace_tpu.bvh.golden import HitRecord

        assert (tri >= 0).mean() > 0.1
        assert_hits_match_brute(HitRecord(tri, t, u, v), brute)

    def test_structured_scene(self, rng):
        scene = get_scene("conference", n_tris=5000)
        o, d, tmin, tmax = random_rays(rng, 800, extent=9.0)
        tri, t, u, v = _trace(scene, o, d, tmin, tmax)
        brute = brute_force_mt(scene, o, d, tmin, tmax)
        from ntrace_tpu.bvh.golden import HitRecord

        assert_hits_match_brute(HitRecord(tri, t, u, v), brute)

    def test_any_hit(self, soup_small, rng):
        o, d, tmin, tmax = random_rays(rng, 800)
        tri, *_ = _trace(soup_small, o, d, tmin, tmax, any_hit=True)
        blocked = brute_force_anyhit(soup_small, o, d, tmin, tmax)
        np.testing.assert_array_equal(tri >= 0, blocked)

    def test_early_exit_front_to_back(self):
        """Two stacked quads: the kd engine must return the FRONT one."""
        scene = make_two_quads()
        o = np.array([[0.0, 0.0, 0.0]], np.float32)
        d = np.array([[0.0, 0.0, 1.0]], np.float32)
        tri, t, u, v = _trace(scene, o, d, np.zeros(1, np.float32),
                              np.full(1, 1e9, np.float32), chunk=8)
        assert tri[0] in (0, 1) and abs(t[0] - 1.0) < 1e-5

    def test_renderer_kdtree_matches_bvh(self):
        from ntrace_tpu.render import render_frame

        scene = get_scene("conference", n_tris=4000)
        rk = render_frame(scene, cfg=RenderConfig(width=48, height=32, engine="kdtree"),
                          build_cfg=BuildConfig(builder="kdtree"))
        rb = render_frame(scene, cfg=RenderConfig(width=48, height=32))
        same = (rk.hit_tri == rb.hit_tri).mean()
        assert same > 0.998, f"agreement {same}"


class TestKDCellBoxView:
    """kd_to_flatbvh: the kd tree re-expressed as a BVH of cell boxes must
    trace identically (the GPU kernel runs over it under engine auto)."""

    def test_cellbox_golden_matches_brute(self, rng):
        from ntrace_tpu.bvh.kdtree import kd_to_flatbvh
        from ntrace_tpu.trace.cpu import trace_cpu_golden

        scene = make_random_soup(n_tris=1200, seed=23)
        kd = build_kdtree(scene, BuildConfig(builder="kdtree"))
        flat = kd_to_flatbvh(kd)
        o, d, tn, tx = random_rays(rng, 800)
        rec = trace_cpu_golden(flat, o, d, tn, tx)
        brute = brute_force_mt(scene, o, d, tn, tx)
        # Near-origin hits (|t| ~ 3e-3 in this soup) carry woop-vs-MT
        # absolute epsilon above the default 2e-4 relative gate; ids match.
        assert_hits_match_brute(rec, brute, t_rtol=5e-4)

    def test_cellbox_packet_matches_interval_stack(self, rng):
        from ntrace_tpu.bvh.kdtree import kd_to_flatbvh
        from ntrace_tpu.trace.ww_kernel import trace_ww

        scene = make_random_soup(n_tris=600, seed=29)
        kd = build_kdtree(scene, BuildConfig(builder="kdtree"))
        flat = kd_to_flatbvh(kd)
        fut, f_nodes = unify_tables(flat)
        o, d, tn, tx = random_rays(rng, 512)
        got = trace_ww(jnp.asarray(fut), f_nodes, jnp.asarray(o),
                       jnp.asarray(d), jnp.asarray(tn), jnp.asarray(tx),
                       interpret=True)
        ut, n_nodes = unify_tables(kd)
        ref = trace_kd(jnp.asarray(ut), n_nodes, jnp.asarray(kd.root_lo),
                       jnp.asarray(kd.root_hi), jnp.asarray(o),
                       jnp.asarray(d), jnp.asarray(tn), jnp.asarray(tx),
                       chunk=512)
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
        hit = np.asarray(ref[0]) >= 0
        np.testing.assert_allclose(np.asarray(got[1])[hit],
                                   np.asarray(ref[1])[hit], rtol=1e-5)
