"""Golden conformance of the v1 two-table lockstep engine (trace/stack_jax.py);
see tests/conformance.py for the rules."""

import pytest

from conformance import BUILDERS, MODES, SCENES, run


@pytest.mark.parametrize("any_hit", MODES)
@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("scene", SCENES)
def test_conformance(scene, builder, any_hit):
    run("stack", scene, builder, any_hit)
