"""The port's ``sliding_window_gdg`` against the JAX package (f32, CPU):
with the last window re-decoded by BP+OSD (``last_win_osd=True``). The case
and the JAX run live in ``_torch_gdg_sw.py``; ``test_torch_gdg_sw.py``
holds the case of GDG alone."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
import _torch_gdg_sw as case  # noqa: E402


@pytest.fixture(scope="module")
def jax_sw():
    return case.jax_sw()


@pytest.mark.parametrize("last_win_osd", [True])
def test_sliding_window_gdg_matches_jax(jax_sw, last_win_osd):
    """See ``_torch_gdg_sw.check_sliding_window_gdg``."""
    case.check_sliding_window_gdg(jax_sw, last_win_osd)
