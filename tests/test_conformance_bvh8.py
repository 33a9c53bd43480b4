"""Golden conformance of the 8-wide one-dispatch engine (trace/wide_jax.py);
soup scene (the room is in test_conformance_bvh8_room.py); see
tests/conformance.py for the rules."""

import pytest

from conformance import BUILDERS, MODES, run


@pytest.mark.parametrize("any_hit", MODES)
@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("scene", ["soup"])
def test_conformance(scene, builder, any_hit):
    run("bvh8", scene, builder, any_hit)
