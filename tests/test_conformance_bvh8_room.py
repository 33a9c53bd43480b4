"""Golden conformance of the 8-wide one-dispatch engine (trace/wide_jax.py);
room scene (the soup is in test_conformance_bvh8.py, split so the two
compile-heavy halves run on different workers); see tests/conformance.py
for the rules."""

import pytest

from conformance import BUILDERS, MODES, run


@pytest.mark.parametrize("any_hit", MODES)
@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("scene", ["room"])
def test_conformance(scene, builder, any_hit):
    run("bvh8", scene, builder, any_hit)
