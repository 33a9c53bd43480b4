"""Golden conformance of stack2 over several ray chunks in one dispatch (trace/persistent.py);
see tests/conformance.py for the rules."""

import pytest

from conformance import BUILDERS, MODES, SCENES, run


@pytest.mark.parametrize("any_hit", MODES)
@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("scene", SCENES)
def test_conformance(scene, builder, any_hit):
    run("persistent", scene, builder, any_hit)
