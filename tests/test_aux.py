"""Occlusion-aware builder + video export."""

import numpy as np
import pytest

from ntrace_tpu.bvh.flatten import flatten_bvh
from ntrace_tpu.bvh.golden import brute_force_mt
from ntrace_tpu.bvh.occlusion import build_occlusion_bvh, occlusion_weights
from ntrace_tpu.core import BuildConfig, Camera, RenderConfig
from ntrace_tpu.scenes import default_camera, get_scene, make_random_soup
from ntrace_tpu.trace.cpu import trace_cpu_golden
from tests.conftest import random_rays
from tests.test_bvh import assert_hits_match_brute


class TestOcclusionBuilder:
    def test_weights_prefer_near_facing(self):
        scene = get_scene("conference", n_tris=3000)
        cam = default_camera("conference")
        w = occlusion_weights(scene, cam)
        assert w.shape == (scene.num_tris,) and (w > 0).all()
        cent = scene.tri_verts().mean(axis=1)
        d2 = ((cent - cam.position) ** 2).sum(axis=1)
        near = w[d2 < np.percentile(d2, 10)].mean()
        far = w[d2 > np.percentile(d2, 90)].mean()
        assert near > far, "near geometry must weigh more"

    def test_traversal_matches_brute(self, rng):
        scene = make_random_soup(n_tris=2000, seed=31)
        cam = Camera(position=[0, 0, 20], forward=[0, 0, -1])
        bvh = build_occlusion_bvh(scene, cam)
        bvh.validate(scene.num_tris)
        flat = flatten_bvh(bvh, scene)
        o, d, tmin, tmax = random_rays(rng, 1000)
        rec = trace_cpu_golden(flat, o, d, tmin, tmax)
        brute = brute_force_mt(scene, o, d, tmin, tmax)
        assert_hits_match_brute(rec, brute)

    def test_uniform_weights_recover_standard_sah(self):
        from ntrace_tpu.bvh.occlusion import _OcclusionBuilder
        from ntrace_tpu.bvh.sbvh import build_sbvh

        scene = make_random_soup(n_tris=1500, seed=7)
        cfg = BuildConfig(builder="binned_sah")
        std = build_sbvh(scene, cfg)
        b = _OcclusionBuilder(scene, cfg, np.ones(scene.num_tris, np.float32))
        b.build(np.arange(scene.num_tris, dtype=np.int64), 0)
        # Same topology class: identical node count and SAH cost.
        assert len(b.child_rows) == std.num_inner


class TestVideo:
    def test_orbit_gif(self, tmp_path):
        from ntrace_tpu.io.video import export_video, orbit_path
        from ntrace_tpu.render.renderer import Renderer

        scene = get_scene("conference", n_tris=2000)
        r = Renderer(scene, BuildConfig(builder="lbvh"),
                     RenderConfig(width=32, height=24))
        lo, hi = scene.bbox()
        cams = orbit_path((lo + hi) / 2, radius=6.0, height=5.0, n_frames=3)
        out = tmp_path / "orbit.gif"
        stats = export_video(r, cams, str(out), fps=4)
        assert out.exists() and out.stat().st_size > 300
        assert len(stats) == 3

    def test_lerp_path(self):
        from ntrace_tpu.io.video import lerp_path

        a = Camera(position=[0, 0, 0], forward=[0, 0, -1], fov_deg=40)
        b = Camera(position=[2, 0, 0], forward=[1, 0, 0], fov_deg=80)
        cams = lerp_path(a, b, 3)
        np.testing.assert_allclose(cams[1].position, [1, 0, 0])
        assert abs(cams[1].fov_deg - 60) < 1e-5


def test_occlusion_frustum_downweights_out_of_view():
    from ntrace_tpu.bvh.occlusion import occlusion_weights
    from ntrace_tpu.core import Camera
    from ntrace_tpu.scenes import make_random_soup

    scene = make_random_soup(n_tris=500, seed=7)
    cam = Camera(position=[0, 0, 40], forward=[0, 0, -1], fov_deg=30.0)
    w_plain = occlusion_weights(scene, cam)
    w_frust = occlusion_weights(scene, cam, aspect=1.0)
    assert w_plain.shape == w_frust.shape == (500,)
    # A narrow frustum over a centered soup must cut some weights.
    assert (w_frust > 0).all() and not np.allclose(w_plain, w_frust)


class TestCompactRays:
    """Between-pass live-ray compaction (_compact_trace) is pixel-exact.

    The reference's kepler_dynamic_fetch capability (SURVEY.md SS3.3):
    terminated rays must not occupy traversal lanes. The analogue here
    truncates the Morton-sorted batch (dead rays at the end) to a
    padded live prefix; these tests pin that the truncation + result
    re-padding is invisible in the image for every secondary-ray mode.
    """

    @pytest.mark.parametrize("mode", ["ao", "diffuse", "path"])
    def test_pixel_identical(self, mode):
        from ntrace_tpu.render import render_frame

        scene = get_scene("conference", n_tris=3000)
        frames = {}
        for compact in ("off", "on"):
            cfg = RenderConfig(width=128, height=72, mode=mode, samples=2,
                               seed=3, bounces=2, compact_rays=compact)
            frames[compact] = render_frame(
                scene, cfg=cfg, build_cfg=BuildConfig(builder="median"))
        np.testing.assert_array_equal(frames["off"].image,
                                      frames["on"].image)

    def test_prefix_actually_truncates(self):
        from ntrace_tpu.ray.raybatch import RayBatch
        from ntrace_tpu.render.renderer import _compact_trace
        import jax.numpy as jnp

        n, live = 20000, 5000
        calls = {}

        def tracer(o, d, tn, tx, any_hit):
            calls["n"] = o.shape[0]
            r = o.shape[0]
            return (jnp.full((r,), 2, jnp.int32), jnp.ones((r,), jnp.float32),
                    jnp.zeros((r,), jnp.float32), jnp.zeros((r,), jnp.float32))

        tmax = jnp.where(jnp.arange(n) < live, 1.0, 0.0).astype(jnp.float32)
        b = RayBatch(jnp.zeros((n, 3)), jnp.ones((n, 3)),
                     jnp.zeros((n,)), tmax, jnp.arange(n, dtype=jnp.int32))
        tri, t, u, v = _compact_trace(tracer, b, 1 << 20, False, compact="on")
        assert calls["n"] == 8192  # next pow2 of 5000, floored at 8192
        assert tri.shape == (n,)
        assert (np.asarray(tri[:8192]) == 2).all()
        assert (np.asarray(tri[8192:]) == -1).all()


@pytest.mark.parametrize("mode", ["shadow", "ao", "diffuse"])
def test_render_secondary_hits_are_trace_secondary(mode):
    """render() traces its secondary pass through Renderer.trace_secondary
    and returns those hits (traced order), so a check of the returned ids
    checks what render traced."""
    import jax
    import jax.numpy as jnp

    from ntrace_tpu.ray import pixel_table, raygen
    from ntrace_tpu.render.renderer import Renderer

    scene = get_scene("conference", n_tris=3000)
    cam = default_camera("conference")
    W, H = 32, 24
    r = Renderer(scene, BuildConfig(builder="binned_sah"),
                 RenderConfig(width=W, height=H, engine="stack2", samples=2))
    res = r.render(cam, mode=mode)
    batch = raygen.primary(raygen.camera_arrays(cam, W, H), W, H,
                           jnp.asarray(pixel_table(W, H)[0]))
    slot = np.asarray(batch.slot_to_id)
    sec, any_hit = r.gen_secondary(
        cam, mode, batch, jnp.asarray(res.hit_tri[slot]),
        jnp.asarray(res.hit_t[slot]), key=jax.random.PRNGKey(r.cfg.seed))
    assert any_hit == (mode != "diffuse")
    stri = r.trace_secondary(sec, mode)[0]
    assert res.secondary_tri.shape == (sec.num_rays,)
    np.testing.assert_array_equal(np.asarray(stri),
                                  np.asarray(res.secondary_tri))
    assert (np.asarray(stri) >= 0).any()
