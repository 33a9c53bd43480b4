"""The ww while-while GPU kernel vs the brute-force golden.

The kernel compiles for CUDA only; here it runs in the Pallas interpreter
(interpret=True), which executes the same kernel body on the CPU. The
wrapper's padding, miss encoding and backend check are plain Python and
are tested directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ntrace_tpu.bvh.flatten import flatten_bvh
from ntrace_tpu.bvh.golden import brute_force_anyhit, brute_force_mt
from ntrace_tpu.bvh.lbvh import build_lbvh_flat
from ntrace_tpu.bvh.median import build_median_bvh
from ntrace_tpu.bvh.sbvh import build_sbvh
from ntrace_tpu.core import BuildConfig
from ntrace_tpu.trace.stack2_jax import trace_stack2
from ntrace_tpu.trace.unified import unify_tables
from ntrace_tpu.trace.ww_kernel import trace_ww

from conftest import random_rays


def _flat(scene, builder="binned_sah"):
    if builder == "median":
        return flatten_bvh(build_median_bvh(scene), scene)
    if builder == "lbvh":
        return build_lbvh_flat(scene, BuildConfig(builder=builder))
    return flatten_bvh(build_sbvh(scene, BuildConfig(builder=builder)), scene)


def _ww(flat, orig, dirn, tmin, tmax, any_hit=False):
    ut, n_nodes = unify_tables(flat)
    return trace_ww(jnp.asarray(ut), n_nodes, orig, dirn, tmin, tmax,
                    any_hit, interpret=True)


@pytest.mark.parametrize("builder", ["binned_sah", "median", "sbvh", "lbvh"])
def test_packet_matches_golden(soup_small, rng, builder):
    flat = _flat(soup_small, builder)
    orig, dirn, tmin, tmax = random_rays(rng, 700)  # not a BLOCK multiple
    tri, t, u, v = _ww(flat, orig, dirn, tmin, tmax)
    ref = brute_force_mt(soup_small, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(tri), ref.tri)
    hit = ref.tri >= 0
    # Woop (kernel) vs Moller-Trumbore (brute force): two f32 formulations.
    np.testing.assert_allclose(np.asarray(t)[hit], ref.t[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(u)[hit], ref.u[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v)[hit], ref.v[hit], rtol=1e-4, atol=1e-5)


def test_packet_anyhit(soup_medium, rng):
    flat = _flat(soup_medium)
    orig, dirn, tmin, tmax = random_rays(rng, 1024)
    tmax = np.full_like(tmax, 14.0)  # finite segments: some blocked, some not
    tri, t, u, v = _ww(flat, orig, dirn, tmin, tmax, any_hit=True)
    blocked = brute_force_anyhit(soup_medium, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(tri) >= 0, blocked)


def test_packet_dead_rays_stay_dead(soup_small, rng):
    flat = _flat(soup_small)
    orig, dirn, tmin, tmax = random_rays(rng, 256)
    tmax[:] = 0.0  # zero-length segments: the renderer's dead-ray encoding
    tri, t, u, v = _ww(flat, orig, dirn, tmin, tmax, any_hit=True)
    assert (np.asarray(tri) == -1).all()


@pytest.mark.parametrize("n_rays", [1, 63, 64, 65, 200])
def test_ww_padding_matches_stack2(soup_small, rng, n_rays):
    """Ray counts off the block size: padding lanes never leak into the
    result, and every real ray agrees with stack2 bit for bit on ids."""
    flat = _flat(soup_small)
    orig, dirn, tmin, tmax = random_rays(rng, n_rays)
    got = _ww(flat, orig, dirn, tmin, tmax)
    ut, n_nodes = unify_tables(flat)
    ref = trace_stack2(jnp.asarray(ut), n_nodes, orig, dirn, tmin, tmax)
    assert all(np.asarray(g).shape == (n_rays,) for g in got)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))


def test_ww_all_miss_encoding(soup_small, rng):
    """Rays pointing away from the scene: tri -1, t inf, u = v = 0."""
    flat = _flat(soup_small)
    n = 96
    orig = np.tile(np.array([[0.0, 100.0, 0.0]], np.float32), (n, 1))
    dirn = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (n, 1))
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e9, np.float32)
    for any_hit in (False, True):
        tri, t, u, v = _ww(flat, orig, dirn, tmin, tmax, any_hit=any_hit)
        assert (np.asarray(tri) == -1).all()
        assert np.isinf(np.asarray(t)).all()
        assert not np.asarray(u).any() and not np.asarray(v).any()


def test_ww_zero_direction_components(rng):
    """Axis-aligned rays (two direction components exactly +-0) go through
    the reference's epsilon-guarded reciprocal and still hit."""
    from ntrace_tpu.scenes import make_two_quads

    scene = make_two_quads()
    flat = _flat(scene, "median")
    lo, hi = scene.bbox()
    c = (lo + hi) / 2
    orig, dirn = [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            o = c.copy()
            o[axis] = (lo[axis] - 1.0) if sign > 0 else (hi[axis] + 1.0)
            d = np.zeros(3, np.float32)
            d[axis] = sign
            orig.append(o)
            dirn.append(d)
    orig = np.asarray(orig, np.float32)
    dirn = np.asarray(dirn, np.float32)
    neg = dirn[1::2]
    neg[neg == 0] = -0.0   # negative zeros on every other ray
    tmin = np.zeros(len(orig), np.float32)
    tmax = np.full(len(orig), 1e9, np.float32)
    tri, t, _, _ = _ww(flat, orig, dirn, tmin, tmax)
    ref = brute_force_mt(scene, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(tri), ref.tri)
    assert (ref.tri >= 0).any()


def test_ww_refuses_cpu_without_interpret(soup_small, rng):
    """Naming the kernel where it cannot compile is an error, never a
    silent interpreter fallback -- in the wrapper and in the Renderer."""
    from ntrace_tpu.core import RenderConfig
    from ntrace_tpu.render.renderer import Renderer

    flat = _flat(soup_small)
    ut, n_nodes = unify_tables(flat)
    orig, dirn, tmin, tmax = random_rays(rng, 32)
    with pytest.raises(RuntimeError, match="interpret=True"):
        trace_ww(jnp.asarray(ut), n_nodes, orig, dirn, tmin, tmax)
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        Renderer(soup_small, BuildConfig(builder="binned_sah"),
                 RenderConfig(width=8, height=8, engine="ww"), flat=flat)
