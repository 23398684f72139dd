"""The port's ``sliding_window_gdg`` against the JAX package (f32, CPU):
GDG alone (``last_win_osd=False``). The case and the JAX run live in
``_torch_gdg_sw.py``; ``test_torch_gdg_sw_osd.py`` holds the case with
the last window's BP+OSD re-decode."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
import _torch_gdg_sw as case  # noqa: E402


@pytest.fixture(scope="module")
def jax_sw():
    return case.jax_sw()


@pytest.mark.parametrize("last_win_osd", [False])
def test_sliding_window_gdg_matches_jax(jax_sw, last_win_osd):
    """See ``_torch_gdg_sw.check_sliding_window_gdg``."""
    case.check_sliding_window_gdg(jax_sw, last_win_osd)
