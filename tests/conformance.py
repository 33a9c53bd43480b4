"""Engine conformance against the CPU golden tracer (shared by the
test_conformance_*.py files, one per engine, so pytest-xdist's loadfile
scheduling spreads the matrix over workers).

Every engine that stays runs every builder on two scenes -- an incoherent
random soup and a structured room seen through a camera -- in closest-hit
and any-hit mode, on the same FlatBVH the golden tracer walks.

Rules:
  closest hit : hit ids equal the golden's except at distance ties, where
                golden_mismatches (trace/cpu.py) lets a different id pass
                when t agrees within 4 float32 ulps (shared mesh edges);
                t agrees to rtol 1e-5 on every ray whose id agrees (XLA may
                fuse a*b+c into one rounding where numpy rounds twice).
  any hit     : the occluded/unoccluded flag equals the golden's exactly;
                a reported occluder lies inside [tmin, tmax].
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.render.renderer import build_accel, make_tracer
from ntrace_tpu.trace.cpu import golden_mismatches, trace_cpu_golden

BUILDERS = ["median", "binned_sah", "sbvh", "lbvh", "hlbvh", "kd_cellbox"]
SCENES = ["soup", "room"]
MODES = [False, True]   # any_hit


@functools.lru_cache(maxsize=None)
def scene_and_rays(name: str):
    from ntrace_tpu.ray import pixel_table, raygen
    from ntrace_tpu.scenes import default_camera, get_scene, make_random_soup

    if name == "soup":
        scene = make_random_soup(n_tris=600, seed=31)
        rng = np.random.default_rng(5)
        n = 384
        orig = rng.uniform(-12, 12, size=(n, 3)).astype(np.float32)
        d = rng.uniform(-4, 4, size=(n, 3)) - orig
        dirn = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
            np.float32)
        tmin = np.zeros(n, np.float32)
        tmax = np.full(n, 1e9, np.float32)
    else:
        scene = get_scene("conference", n_tris=3000)
        w, h = 24, 16
        cam = raygen.camera_arrays(default_camera("conference"), w, h)
        order, _ = pixel_table(w, h)
        b = raygen.primary(cam, w, h, jnp.asarray(order))
        orig, dirn, tmin, tmax = (np.asarray(a, np.float32) for a in (
            b.orig, b.dirn, b.tmin, b.tmax))
    return scene, (orig, dirn, tmin, tmax)


@functools.lru_cache(maxsize=None)
def flat_for(scene_name: str, builder: str):
    from ntrace_tpu.bvh.kdtree import kd_to_flatbvh

    scene, _ = scene_and_rays(scene_name)
    if builder == "kd_cellbox":
        return kd_to_flatbvh(build_accel(scene, BuildConfig(builder="kdtree")))
    return build_accel(scene, BuildConfig(builder=builder))


def rays_for(scene_name: str, any_hit: bool):
    scene, (orig, dirn, tmin, tmax) = scene_and_rays(scene_name)
    if any_hit:
        # Finite segments, so some rays are blocked and some are not.
        lo, hi = scene.bbox()
        tmax = np.full_like(tmax, 0.3 * float(np.linalg.norm(hi - lo)))
    return orig, dirn, tmin, tmax


def check(got, gold, tmin, tmax, any_hit: bool):
    tri = np.asarray(got[0])
    t = np.asarray(got[1])
    if any_hit:
        np.testing.assert_array_equal(tri >= 0, gold.tri >= 0)
        hit = tri >= 0
        assert ((t[hit] > tmin[hit]) & (t[hit] < tmax[hit])).all()
        return
    assert golden_mismatches(tri, t, gold.tri, gold.t) == 0
    same = (tri == gold.tri) & (gold.tri >= 0)
    np.testing.assert_allclose(t[same], gold.t[same], rtol=1e-5)
    assert (gold.tri >= 0).any()


def run(engine: str, scene_name: str, builder: str, any_hit: bool):
    """Trace with `engine` and compare with the golden tracer."""
    flat = flat_for(scene_name, builder)
    orig, dirn, tmin, tmax = rays_for(scene_name, any_hit)
    gold = trace_cpu_golden(flat, orig, dirn, tmin, tmax, any_hit=any_hit)
    if engine == "persistent":
        # stack2 over several 128-ray chunks (trace/persistent.py).
        tracer, _ = make_tracer(flat, "stack2",
                                RenderConfig(max_batch_rays=128))
    else:
        tracer, _ = make_tracer(flat, engine, RenderConfig(interpret=True))
    got = tracer(jnp.asarray(orig), jnp.asarray(dirn), jnp.asarray(tmin),
                 jnp.asarray(tmax), any_hit)
    check(got, gold, tmin, tmax, any_hit)
