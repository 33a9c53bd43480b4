"""Multi-device correctness on the conftest 8-virtual-CPU mesh (SURVEY §5:
"multi-node without a cluster"). Sharded results must equal the single-chip
renderer's bit-for-bit -- the accel is replicated and rays are data-parallel,
so any difference is a sharding bug."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ntrace_tpu.bvh.flatten import flatten_bvh
from ntrace_tpu.bvh.sbvh import build_sbvh
from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.parallel.mesh import (
    frame_step, make_mesh, render_step_sharded, trace_sharded,
)
from ntrace_tpu.ray import pixel_table, raygen
from ntrace_tpu.render.renderer import Renderer
from ntrace_tpu.scenes import default_camera
from ntrace_tpu.trace.stack_jax import trace_stack

from conftest import random_rays


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def _flat_dev(scene):
    flat = flatten_bvh(build_sbvh(scene, BuildConfig(builder="binned_sah")), scene)
    return (jnp.asarray(flat.nodes), jnp.asarray(flat.woop),
            jnp.asarray(flat.tri_index))


def test_trace_sharded_matches_single(soup_medium, rng, mesh8):
    nodes, woop, tri_index = _flat_dev(soup_medium)
    orig, dirn, tmin, tmax = random_rays(rng, 2048)  # 2048 % 8 == 0
    args = (jnp.asarray(orig), jnp.asarray(dirn),
            jnp.asarray(tmin), jnp.asarray(tmax))
    sh = trace_sharded(mesh8, nodes, woop, tri_index, *args)
    single = trace_stack(nodes, woop, tri_index, *args)
    for s, g in zip(sh, single):
        np.testing.assert_array_equal(np.asarray(s), np.asarray(g))


def test_trace_sharded_anyhit(soup_medium, rng, mesh8):
    nodes, woop, tri_index = _flat_dev(soup_medium)
    orig, dirn, tmin, tmax = random_rays(rng, 1024)
    tmax = np.full_like(tmax, 10.0)
    args = (jnp.asarray(orig), jnp.asarray(dirn),
            jnp.asarray(tmin), jnp.asarray(tmax))
    sh = trace_sharded(mesh8, nodes, woop, tri_index, *args, any_hit=True)
    single = trace_stack(nodes, woop, tri_index, *args, any_hit=True)
    np.testing.assert_array_equal(
        np.asarray(sh[0]) >= 0, np.asarray(single[0]) >= 0
    )


def test_render_step_sharded_matches_renderer(soup_medium, mesh8):
    """The sharded frame step == the Renderer's shadow mode, pixel-exact."""
    scene = soup_medium
    W, H = 64, 48  # 3072 rays, divisible by 8
    cam = default_camera(scene.name)
    cfg = RenderConfig(width=W, height=H, mode="shadow", engine="stack")
    renderer = Renderer(scene, BuildConfig(builder="binned_sah"), cfg)
    ref = renderer.render(cam)

    order, _ = pixel_table(W, H)
    batch = raygen.primary(raygen.camera_arrays(cam, W, H), W, H,
                           jnp.asarray(order))
    light = jnp.asarray(renderer._default_light(cam), jnp.float32)
    nodes, woop, tri_index = renderer.flat_dev
    color, hits = render_step_sharded(
        mesh8, nodes, woop, tri_index, renderer.geom_normals,
        batch.orig, batch.dirn, batch.tmin, batch.tmax, light,
        eps=float(renderer.eps),
    )
    fb = jnp.zeros((W * H, 3), jnp.float32).at[batch.slot_to_id].set(color)
    img = np.asarray(fb).reshape(H, W, 3)
    np.testing.assert_array_equal(img, ref.image)
    assert int(hits) == int((ref.hit_tri >= 0).sum())


def test_frame_step_single_equals_sharded(soup_small, rng, mesh8):
    """frame_step is one function for both paths; psum==sum at 8 shards."""
    nodes, woop, tri_index = _flat_dev(soup_small)
    gn = jnp.asarray(soup_small.geometric_normals())
    orig, dirn, tmin, tmax = random_rays(rng, 512)
    light = jnp.asarray([0.0, 25.0, 0.0], jnp.float32)
    args = (nodes, woop, tri_index, gn, jnp.asarray(orig), jnp.asarray(dirn),
            jnp.asarray(tmin), jnp.asarray(tmax), light)
    c1, h1 = frame_step(*args, jnp.float32(1e-3))
    c8, h8 = render_step_sharded(mesh8, *args, eps=1e-3)
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c8))
    assert int(h1) == int(h8)


def test_stack2_sharded_matches_single(soup_medium, rng, mesh8):
    """The stack2 engine under shard_map."""
    from ntrace_tpu.parallel.mesh import trace_sharded_unified
    from ntrace_tpu.trace.stack2_jax import trace_stack2
    from ntrace_tpu.trace.unified import unify_tables

    flat = flatten_bvh(build_sbvh(soup_medium, BuildConfig(builder="binned_sah")),
                       soup_medium)
    ut, n_nodes = unify_tables(flat)
    ut = jnp.asarray(ut)
    orig, dirn, tmin, tmax = random_rays(rng, 2048)
    args = (jnp.asarray(orig), jnp.asarray(dirn),
            jnp.asarray(tmin), jnp.asarray(tmax))
    sh = trace_sharded_unified(mesh8, ut, n_nodes, *args)
    single = trace_stack2(ut, n_nodes, *args)
    for s, g in zip(sh, single):
        np.testing.assert_array_equal(np.asarray(s), np.asarray(g))


def test_packet_sharded_matches_single(soup_small, rng, mesh8):
    """The ww kernel under shard_map (interpret mode on the virtual CPU
    mesh): sharded == single, bit-for-bit."""
    from ntrace_tpu.parallel.mesh import trace_sharded_unified
    from ntrace_tpu.trace.unified import unify_tables
    from ntrace_tpu.trace.ww_kernel import trace_ww

    flat = flatten_bvh(build_sbvh(soup_small, BuildConfig(builder="binned_sah")),
                       soup_small)
    ut, n_nodes = unify_tables(flat)
    ut = jnp.asarray(ut)
    orig, dirn, tmin, tmax = random_rays(rng, 1024)
    args = (jnp.asarray(orig), jnp.asarray(dirn),
            jnp.asarray(tmin), jnp.asarray(tmax))
    sh = trace_sharded_unified(mesh8, ut, n_nodes, *args, engine="ww",
                              interpret=True)
    single = trace_ww(ut, n_nodes, *args, interpret=True)
    for s, g in zip(sh, single):
        np.testing.assert_array_equal(np.asarray(s), np.asarray(g))


def test_render_step_sharded_stack2_matches_renderer(soup_medium, mesh8):
    """Full sharded frame (primary + shadow + shading + psum) on stack2
    == the Renderer's shadow mode, pixel-exact."""
    from ntrace_tpu.parallel.mesh import render_step_sharded_unified

    scene = soup_medium
    W, H = 64, 48
    cam = default_camera(scene.name)
    cfg = RenderConfig(width=W, height=H, mode="shadow", engine="stack2")
    renderer = Renderer(scene, BuildConfig(builder="binned_sah"), cfg)
    ref = renderer.render(cam)

    order, _ = pixel_table(W, H)
    batch = raygen.primary(raygen.camera_arrays(cam, W, H), W, H,
                           jnp.asarray(order))
    light = jnp.asarray(renderer._default_light(cam), jnp.float32)
    color, hits = render_step_sharded_unified(
        mesh8, renderer.ut_dev, renderer.ut_nodes, renderer.geom_normals,
        batch.orig, batch.dirn, batch.tmin, batch.tmax, light,
        eps=float(renderer.eps),
    )
    fb = jnp.zeros((W * H, 3), jnp.float32).at[batch.slot_to_id].set(color)
    img = np.asarray(fb).reshape(H, W, 3)
    np.testing.assert_array_equal(img, ref.image)
    assert int(hits) == int((ref.hit_tri >= 0).sum())
