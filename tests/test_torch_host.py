"""The port's copies of the numpy host modules agree with the JAX package:
codes, circuits, DEM, window plan and DEM sampling are array-equal."""

import numpy as np
import pytest

from slidingwindowdecoder_torch.circuits import sample_dem_numpy as t_sample
from slidingwindowdecoder_torch.codes import bb_code_by_n as t_code
from slidingwindowdecoder_torch.harness.circuit_level import (
    build_bb_window_experiment as t_build,
)
from slidingwindowdecoder_torch.utils import gf2 as t_gf2
from slidingwindowdecoder_tpu.circuits import sample_dem_numpy as j_sample
from slidingwindowdecoder_tpu.codes import bb_code_by_n as j_code
from slidingwindowdecoder_tpu.harness.circuit_level import (
    build_bb_window_experiment as j_build,
)
from slidingwindowdecoder_tpu.utils import gf2 as j_gf2

CASES = [(72, 3, 2), (144, 12, 3)]


@pytest.mark.parametrize("N,rounds,W", CASES)
def test_experiment_and_samples_equal(N, rounds, W):
    _, _, t_dem, t_plan = t_build(N, 0.004, rounds, W, 1)
    _, _, j_dem, j_plan = j_build(N, 0.004, rounds, W, 1)
    for name in ("chk", "obs", "priors"):
        np.testing.assert_array_equal(getattr(t_dem, name), getattr(j_dem, name))
    for name in ("chk", "obs", "priors", "column_perm"):
        np.testing.assert_array_equal(getattr(t_plan, name), getattr(j_plan, name))
    assert t_plan.anchors == j_plan.anchors
    assert len(t_plan.windows) == len(j_plan.windows)
    for tw, jw in zip(t_plan.windows, j_plan.windows):
        np.testing.assert_array_equal(tw.mat, jw.mat)
        np.testing.assert_array_equal(tw.prior, jw.prior)
        for attr in ("index", "row_start", "row_end", "col_start",
                     "commit_col_end", "col_end", "is_last"):
            assert getattr(tw, attr) == getattr(jw, attr), attr

    t_out = t_sample(t_dem, 64, np.random.default_rng(2024))
    j_out = j_sample(j_dem, 64, np.random.default_rng(2024))
    for a, b in zip(t_out, j_out):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("N", [72, 144])
def test_codes_equal(N):
    tc, ta, tb = t_code(N)
    jc, ja, jb = j_code(N)
    np.testing.assert_array_equal(tc.hx, jc.hx)
    np.testing.assert_array_equal(tc.hz, jc.hz)
    assert (tc.N, tc.K) == (jc.N, jc.K)
    for x, y in zip(ta + tb, ja + jb):
        np.testing.assert_array_equal(x, y)


def test_gf2_utils_equal(rng):
    A = (rng.random((12, 20)) < 0.4).astype(np.uint8)
    assert t_gf2.rank(A) == j_gf2.rank(A)
    for a, b in zip(t_gf2.kernel(A), j_gf2.kernel(A)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_gf2.row_basis(A), j_gf2.row_basis(A))
