"""Golden conformance of the unified-table lockstep engine, one chunk (trace/stack2_jax.py);
see tests/conformance.py for the rules."""

import pytest

from conformance import BUILDERS, MODES, SCENES, run


@pytest.mark.parametrize("any_hit", MODES)
@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("scene", SCENES)
def test_conformance(scene, builder, any_hit):
    run("stack2", scene, builder, any_hit)
