"""JAX stack engine vs CPU golden tracer and vs brute force.

The image-exact acceptance gate (SURVEY.md SS8 M2): every JAX engine run on
the SAME flattened BVH must reproduce the golden tracer's hit ids and
distances (1-2 ulp tolerance on t for compiler fma differences; ids exact
except at genuine t ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ntrace_tpu.bvh.flatten import flatten_bvh
from ntrace_tpu.bvh.golden import brute_force_anyhit, brute_force_mt
from ntrace_tpu.bvh.median import build_median_bvh
from ntrace_tpu.scenes import get_scene, make_random_soup
from ntrace_tpu.trace.cpu import trace_cpu_golden
from ntrace_tpu.trace.stack_jax import trace_stack
from tests.conftest import random_rays
from tests.test_bvh import assert_hits_match_brute


def _flat_dev(flat):
    return jnp.asarray(flat.nodes), jnp.asarray(flat.woop), jnp.asarray(flat.tri_index)


def assert_engine_matches_golden(jtri, jt, ju, jv, golden, t_ulps=4):
    jtri = np.asarray(jtri)
    jt = np.asarray(jt)
    same = jtri == golden.tri
    if not same.all():
        bad = ~same
        np.testing.assert_allclose(
            jt[bad], golden.t[bad], rtol=1e-6,
            err_msg="engine/golden id mismatch without a t tie",
        )
    hit = same & (golden.tri >= 0)
    # t within compiler fma/reassociation slack (XLA may fuse mul+add).
    gt = golden.t[hit]
    ulp = np.spacing(np.abs(gt).astype(np.float32)) * t_ulps
    # Absolute floor scales with intermediate magnitudes (oz/dz dot
    # products), not with t itself -- cancellation error is absolute.
    tol = np.maximum(np.maximum(ulp, 1e-4), 1e-5 * np.abs(gt))
    assert (np.abs(jt[hit] - gt) <= tol).all(), (
        f"max t dev {np.abs(jt[hit] - gt).max()}"
    )
    np.testing.assert_allclose(np.asarray(ju)[hit], golden.u[hit], atol=1e-4)
    np.testing.assert_allclose(np.asarray(jv)[hit], golden.v[hit], atol=1e-4)


class TestStackEngine:
    @pytest.mark.parametrize("n_tris,seed", [(500, 7), (5000, 11)])
    def test_matches_golden_and_brute(self, rng, n_tris, seed):
        scene = make_random_soup(n_tris=n_tris, seed=seed)
        flat = flatten_bvh(build_median_bvh(scene), scene)
        o, d, tmin, tmax = random_rays(rng, 1500)
        golden = trace_cpu_golden(flat, o, d, tmin, tmax)
        jtri, jt, ju, jv = trace_stack(
            *_flat_dev(flat), jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tmin), jnp.asarray(tmax),
        )
        assert_engine_matches_golden(jtri, jt, ju, jv, golden)
        brute = brute_force_mt(scene, o, d, tmin, tmax)
        from ntrace_tpu.bvh.golden import HitRecord

        rec = HitRecord(np.asarray(jtri), np.asarray(jt), np.asarray(ju), np.asarray(jv))
        assert_hits_match_brute(rec, brute)

    def test_any_hit(self, soup_small, rng):
        flat = flatten_bvh(build_median_bvh(soup_small), soup_small)
        o, d, tmin, tmax = random_rays(rng, 1000)
        jtri, *_ = trace_stack(
            *_flat_dev(flat), jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tmin), jnp.asarray(tmax), any_hit=True,
        )
        blocked = brute_force_anyhit(soup_small, o, d, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(jtri) >= 0, blocked)

    def test_structured_scene_camera_rays(self, rng):
        scene = get_scene("conference", n_tris=8000)
        flat = flatten_bvh(build_median_bvh(scene), scene)
        from ntrace_tpu.ray import pixel_table, raygen
        from ntrace_tpu.scenes import default_camera

        W, H = 64, 48
        order, _ = pixel_table(W, H)
        cam = raygen.camera_arrays(default_camera("conference"), W, H)
        batch = raygen.primary(cam, W, H, jnp.asarray(order))
        golden = trace_cpu_golden(
            flat, np.asarray(batch.orig), np.asarray(batch.dirn),
            np.asarray(batch.tmin), np.asarray(batch.tmax),
        )
        jtri, jt, ju, jv = trace_stack(
            *_flat_dev(flat), batch.orig, batch.dirn, batch.tmin, batch.tmax,
        )
        assert (np.asarray(jtri) >= 0).mean() > 0.95
        assert_engine_matches_golden(jtri, jt, ju, jv, golden)


class TestRenderer:
    def test_primary_render_smoke(self):
        from ntrace_tpu.core import RenderConfig
        from ntrace_tpu.render import render_frame
        from ntrace_tpu.scenes import get_scene

        scene = get_scene("conference", n_tris=5000)
        res = render_frame(scene, cfg=RenderConfig(width=64, height=48, mode="primary"))
        assert res.image.shape == (48, 64, 3)
        assert (res.hit_tri >= 0).mean() > 0.9
        assert res.image.max() > 0.1
        assert "mrays_primary" in res.stats

    @pytest.mark.parametrize("mode", ["shadow", "ao", "diffuse", "path"])
    def test_modes_smoke(self, mode):
        from ntrace_tpu.core import RenderConfig
        from ntrace_tpu.render import render_frame
        from ntrace_tpu.scenes import get_scene

        scene = get_scene("conference", n_tris=3000)
        res = render_frame(
            scene,
            cfg=RenderConfig(width=32, height=24, mode=mode, samples=2, seed=1),
        )
        assert res.image.shape == (24, 32, 3)
        assert np.isfinite(res.image).all()
        assert res.image.max() > 0.01

    def test_ao_visibility_partial_in_clutter(self):
        """AO with a 1-unit radius inside the room: some occlusion, not all."""
        from ntrace_tpu.core import RenderConfig
        from ntrace_tpu.render import render_frame
        from ntrace_tpu.scenes import get_scene

        scene = get_scene("conference", n_tris=3000)
        res_ao = render_frame(scene, cfg=RenderConfig(width=32, height=24, mode="ao", samples=8, ao_radius=1.0))
        res_pr = render_frame(scene, cfg=RenderConfig(width=32, height=24, mode="primary"))
        ratio = res_ao.image.mean() / res_pr.image.mean()
        assert 0.05 < ratio < 0.98, f"AO ratio {ratio}"


class TestStack2Engine:
    """Unified-table macro-step engine must equal v1 and the golden."""

    @pytest.mark.parametrize("unroll", [1, 8])
    def test_matches_v1_exactly(self, rng, unroll):
        from ntrace_tpu.trace.stack2_jax import trace_stack2
        from ntrace_tpu.trace.unified import unify_tables

        scene = make_random_soup(n_tris=2000, seed=17)
        flat = flatten_bvh(build_median_bvh(scene), scene)
        ut, n_nodes = unify_tables(flat)
        o, d, tmin, tmax = random_rays(rng, 1200)
        v1 = trace_stack(
            *_flat_dev(flat), jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tmin), jnp.asarray(tmax),
        )
        v2 = trace_stack2(
            jnp.asarray(ut), n_nodes, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tmin), jnp.asarray(tmax), unroll=unroll,
        )
        np.testing.assert_array_equal(np.asarray(v1[0]), np.asarray(v2[0]))
        np.testing.assert_array_equal(np.asarray(v1[1]), np.asarray(v2[1]))
        np.testing.assert_array_equal(np.asarray(v1[2]), np.asarray(v2[2]))

    def test_any_hit_matches_brute(self, soup_small, rng):
        from ntrace_tpu.trace.stack2_jax import trace_stack2
        from ntrace_tpu.trace.unified import unify_tables

        flat = flatten_bvh(build_median_bvh(soup_small), soup_small)
        ut, n_nodes = unify_tables(flat)
        o, d, tmin, tmax = random_rays(rng, 800)
        jtri, *_ = trace_stack2(
            jnp.asarray(ut), n_nodes, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tmin), jnp.asarray(tmax), any_hit=True,
        )
        blocked = brute_force_anyhit(soup_small, o, d, tmin, tmax)
        np.testing.assert_array_equal(np.asarray(jtri) >= 0, blocked)

    def test_renderer_engines_agree(self):
        from ntrace_tpu.core import BuildConfig, RenderConfig
        from ntrace_tpu.render import render_frame
        from ntrace_tpu.scenes import get_scene

        scene = get_scene("conference", n_tris=4000)
        r1 = render_frame(scene, cfg=RenderConfig(width=48, height=32, engine="stack"))
        r2 = render_frame(scene, cfg=RenderConfig(width=48, height=32, engine="stack2"))
        np.testing.assert_array_equal(r1.hit_tri, r2.hit_tri)
        np.testing.assert_array_equal(r1.image, r2.image)


class TestGoldenCompare:
    def test_tie_aware_mismatch_count(self):
        from ntrace_tpu.trace.cpu import golden_mismatches

        t_g = np.float32([1.0, 2.0, 3.0, 4.0, np.inf, 5.0])
        # within-4-ulp perturbations of the finite entries
        t_d = t_g.copy()
        for i in (0, 1, 2, 3):
            for _ in range(2):
                t_d[i] = np.nextafter(t_d[i], np.float32(1e9))
        tri_g = np.int32([1, 2, 3, 4, -1, 6])
        tri_d = np.int32([1, 9, 3, 4, 5, 6])
        # tri 9 vs 2 at t within 2 ulp -> shared-edge tie, not a mismatch
        # tri 5 vs miss -> mismatch regardless of t
        assert golden_mismatches(tri_d, t_d, tri_g, t_g) == 1
        # same ids always match even when t drifts
        t_far = t_g * np.float32(1.5)
        assert golden_mismatches(tri_g, t_far, tri_g, t_g) == 0
        # differing id with t beyond the ulp window is a real mismatch
        t_d2 = t_g.copy()
        t_d2[1] = np.float32(2.001)
        assert golden_mismatches(tri_d, t_d2, tri_g, t_g) == 2
        # poison (-2) never ties
        tri_p = tri_g.copy()
        tri_p[0] = -2
        assert golden_mismatches(tri_p, t_g, tri_g, t_g) == 1
