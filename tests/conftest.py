"""Test harness config: force JAX onto CPU with 8 virtual devices.

Multi-device sharding tests run on a virtual CPU mesh (SURVEY.md SS5,
"multi-node without a cluster"). The GPU kernel runs here in the Pallas
interpreter; on a card it is exercised by chip_smoke.py.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ntrace_tpu.scenes import make_random_soup  # noqa: E402


@pytest.fixture(scope="session")
def soup_small():
    return make_random_soup(n_tris=500, seed=7)


@pytest.fixture(scope="session")
def soup_medium():
    return make_random_soup(n_tris=5000, seed=11)


@pytest.fixture()
def rng():
    # Function-scoped: every test sees the same ray stream regardless of
    # which other tests ran (order-independent determinism).
    return np.random.default_rng(1234)


def random_rays(rng, n, extent=12.0, toward_origin=True):
    """Rays from a shell around the scene pointing inward-ish."""
    orig = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    if toward_origin:
        target = rng.uniform(-extent / 3, extent / 3, size=(n, 3))
        d = target - orig
    else:
        d = rng.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros((n,), dtype=np.float32)
    tmax = np.full((n,), 1e9, dtype=np.float32)
    return orig.astype(np.float32), d.astype(np.float32), tmin, tmax
