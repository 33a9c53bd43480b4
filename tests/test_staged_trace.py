"""staged_closest_trace exactness (r5: fairy-diffuse incoherent lever).

The staged multi-interval decomposition must be bit-identical to the
plain closest-hit trace on hit ids and hit-lane t/u/v, for arbitrary
stage radii -- including degenerate ones (zero-length near interval,
radius beyond every hit, several stages). Property: closest hit in
[tn, tx) = hit in [tn, r) when one exists, else the full retrace's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from ntrace_tpu.core import BuildConfig, RenderConfig, config_replace
from ntrace_tpu.render.renderer import (Renderer, build_accel,
                                        staged_closest_trace)
from ntrace_tpu.scenes import make_random_soup


@pytest.fixture(scope="module")
def rig():
    scene = make_random_soup(n_tris=900, seed=23)
    bcfg = BuildConfig(builder="binned_sah", max_leaf_size=8)
    flat = build_accel(scene, bcfg, use_cache=False)
    r = Renderer(scene, bcfg, RenderConfig(width=32, height=32, engine="ww",
                                           interpret=True),
                 flat=flat)
    rng = np.random.RandomState(3)
    R = 1024
    lo, hi = scene.bbox()
    span = hi - lo
    o = (lo + rng.rand(R, 3) * span).astype(np.float32)
    d = rng.randn(R, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = np.zeros(R, np.float32)
    tx = np.full(R, float(np.linalg.norm(span)) * 2, np.float32)
    # A dead tail, as after a coherence sort.
    tx[-64:] = 0.0
    args = tuple(map(jnp.asarray, (o, d, tn, tx)))
    plain = r._tracer(*args, False)
    return r, args, plain


@pytest.mark.parametrize("radii_frac", [
    (0.05,), (0.25,), (2.0,), (0.0,), (0.02, 0.1), (0.05, 0.2, 0.8)])
def test_staged_matches_plain(rig, radii_frac):
    r, args, plain = rig
    radii = tuple(f * r.scene_scale for f in radii_frac)
    got = staged_closest_trace(r._tracer, *args, radii)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(plain[0]))
    hit = np.asarray(plain[0]) >= 0
    for g, p in zip(got[1:], plain[1:]):
        np.testing.assert_array_equal(np.asarray(g)[hit],
                                      np.asarray(p)[hit])


def test_secondary_tracer_staged_gate(rig, monkeypatch):
    """stage_secondary='on' must route long closest-hit rays through the
    staged path and stay exact; any_hit passes through unchanged."""
    r, args, plain = rig
    r2 = Renderer(r.scene, r.build_cfg,
                  config_replace(r.cfg, stage_secondary="on",
                                 stage_radii=(0.1,)), flat=r.flat)
    tr = r2._secondary_tracer(long_rays=True)
    got = tr(*args, False)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(plain[0]))
    ah_plain = r2._tracer(*args, True)
    ah_staged = tr(*args, True)
    np.testing.assert_array_equal(np.asarray(ah_staged[0]),
                                  np.asarray(ah_plain[0]))
