"""Golden conformance of the interval-stack kd engine (trace/kdtree_jax.py)
on kd accels; the golden walks the same tree's cell-box FlatBVH view.
See tests/conformance.py for the rules."""

import jax.numpy as jnp
import pytest

from conformance import MODES, SCENES, check, rays_for, scene_and_rays
from ntrace_tpu.bvh.kdtree import kd_to_flatbvh
from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.render.renderer import build_accel, make_tracer
from ntrace_tpu.trace.cpu import trace_cpu_golden


@pytest.mark.parametrize("any_hit", MODES)
@pytest.mark.parametrize("scene", SCENES)
def test_conformance(scene, any_hit):
    kd = build_accel(scene_and_rays(scene)[0], BuildConfig(builder="kdtree"))
    orig, dirn, tmin, tmax = rays_for(scene, any_hit)
    gold = trace_cpu_golden(kd_to_flatbvh(kd), orig, dirn, tmin, tmax,
                            any_hit=any_hit)
    tracer, _ = make_tracer(kd, "kdtree", RenderConfig())
    got = tracer(jnp.asarray(orig), jnp.asarray(dirn), jnp.asarray(tmin),
                 jnp.asarray(tmax), any_hit)
    check(got, gold, tmin, tmax, any_hit)
