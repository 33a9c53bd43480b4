"""Golden conformance of the per-ray while-while GPU kernel in the Pallas interpreter (trace/ww_kernel.py);
see tests/conformance.py for the rules."""

import pytest

from conformance import BUILDERS, MODES, SCENES, run


@pytest.mark.parametrize("any_hit", MODES)
@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("scene", SCENES)
def test_conformance(scene, builder, any_hit):
    run("ww", scene, builder, any_hit)
