"""The port's GF(2) elimination and OSD-CS against the JAX package.

The plain elimination (the CPU side of ``ops.gf2_cuda``) is held bit-exact
to the JAX ``ordered_gauss_jordan_key`` and to the Pallas kernel in
interpret mode fed with rank positions, on window PCMs of the [[72]] W=2
experiment (including the rank-deficient last window, 72x468 of rank 66).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
from slidingwindowdecoder_torch.ops import gf2_solve as tg
from slidingwindowdecoder_torch.ops.gf2_cuda import (
    gauss_jordan_key,
    gauss_jordan_order,
    rank_position_keys,
)
from slidingwindowdecoder_tpu.ops import gf2_solve as jg
from slidingwindowdecoder_tpu.ops.gf2_pallas import ordered_gauss_jordan_pallas

KEYS = ["osd0", "piv_col", "piv_row", "reduced_wm", "synd_bits", "sol_bits",
        "inconsistent"]


def _windows():
    _, _, _, plan = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    return plan.windows


def _np(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def _assert_gj_equal(out_t, out_j):
    for k in KEYS:
        np.testing.assert_array_equal(_np(out_t[k]), _np(out_j[k]), err_msg=k)


def _inputs(rng, H, B):
    m, n = H.shape
    synd = (rng.random((B, m)) < 0.5).astype(np.uint8)
    # coarse keys: many exact ties, which go to the lower column
    key = (rng.integers(0, 16, (B, n)) * 0.5).astype(np.float32)
    return synd, key


@pytest.mark.parametrize("win", [0, 2])
def test_gj_key_matches_jax(rng, win):
    H = _windows()[win].mat
    m, n = H.shape
    rank = tg.gf2_rank_packed(H)
    synd, key = _inputs(rng, H, 16)
    Hw = tg.pack_rows_host(H)
    before = gauss_jordan_key.plain_calls
    out_t = gauss_jordan_key(torch.from_numpy(Hw.view(np.int32)), torch.from_numpy(synd),
                             torch.from_numpy(key), m=m, n=n, rank=rank)
    assert gauss_jordan_key.plain_calls == before + 1
    out_j = jg.ordered_gauss_jordan_key(jnp.asarray(Hw), jnp.asarray(synd),
                                        jnp.asarray(key), m=m, n=n, rank=rank)
    _assert_gj_equal(out_t, out_j)
    if win == 2:  # rank 66 < 72 rows: random syndromes leave the span
        assert rank < m and np.asarray(out_j["inconsistent"]).any()


def test_gj_order_matches_pallas_interpret(rng):
    H = _windows()[2].mat
    m, n = H.shape
    rank = tg.gf2_rank_packed(H)
    B = 4
    synd = (rng.random((B, m)) < 0.5).astype(np.uint8)
    order = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    Hw = tg.pack_rows_host(H)
    out_t = gauss_jordan_order(torch.from_numpy(Hw.view(np.int32)),
                               torch.from_numpy(synd), torch.from_numpy(order),
                               m=m, n=n, rank=rank)
    out_p = ordered_gauss_jordan_pallas(jnp.asarray(Hw), jnp.asarray(synd),
                                        jnp.asarray(order), m=m, n=n, rank=rank,
                                        interpret=True)
    _assert_gj_equal(out_t, out_p)
    assert np.asarray(out_p["inconsistent"]).any()


def test_rank_position_keys(rng):
    order = np.stack([rng.permutation(9) for _ in range(3)])
    keys = rank_position_keys(torch.from_numpy(order)).numpy()
    for b in range(3):
        np.testing.assert_array_equal(keys[b, order[b]], np.arange(9))


def test_host_helpers_match_jax(rng):
    H = _windows()[1].mat
    np.testing.assert_array_equal(tg.pack_rows_host(H), jg.pack_rows_host(H))
    assert tg.gf2_rank_packed(H) == jg.gf2_rank_packed(H)
    for method, k, order in (("osd_cs", 30, 5), ("osd_e", 8, 3), ("osd_0", 5, 0)):
        pt = tg.osd_candidate_patterns(k, order, method)
        np.testing.assert_array_equal(pt, jg.osd_candidate_patterns(k, order, method))
        mt, mj = tg.analyze_patterns(pt, k), jg.analyze_patterns(pt, k)
        assert mt["kind"] == mj["kind"]
        for key in set(mt) - {"kind"}:
            np.testing.assert_array_equal(np.asarray(mt[key]), np.asarray(mj[key]))


@pytest.mark.parametrize("win, jitter", [(0, False), (2, False), (0, True), (2, True)],
                         ids=["0", "2", "0-jitter", "2-jitter"])
def test_osd_cs_matches_jax(rng, win, jitter):
    """OSD-0 and inconsistency flags equal; ``min_pm`` within rtol 1e-6,
    because the f32 sums of the path metrics run in other orders; equal
    solutions on every shot but exact ties. With the window's own priors
    (few distinct values) candidates that swap columns of equal prior have
    equal path metrics, and each side's sum order may round another one
    lower: a shot the two decode differently must be such a tie (both
    corrections satisfy the syndrome, their metrics are equal in f64).
    Jittered priors leave no ties, and there every solution is equal."""
    spec = _windows()[win]
    H = spec.mat
    m, n = H.shape
    rank = tg.gf2_rank_packed(H)
    k = n - rank
    B = 32
    synd = (rng.random((B, m)) < 0.08).astype(np.uint8)
    # posterior-like reliabilities: distinct floats, as BP leaves them
    rel = (rng.standard_normal((B, n)) * 4).astype(np.float32)
    p = spec.prior * (1 + 0.01 * rng.random(n)) if jitter else spec.prior
    llr = np.log((1 - p) / p).astype(np.float32)
    pats = tg.osd_candidate_patterns(k, 4, "osd_cs")
    Hw = tg.pack_rows_host(H)

    out_t = tg.osd_decode(torch.from_numpy(Hw.view(np.int32)), torch.from_numpy(synd),
                          torch.from_numpy(rel), torch.from_numpy(llr), m=m, n=n,
                          rank=rank, k=k, meta=tg.analyze_patterns(pats, k))
    out_j = jg.osd_decode(jnp.asarray(Hw), jnp.asarray(synd), jnp.asarray(rel),
                          jnp.asarray(llr), pats, m=m, n=n, rank=rank, k=k,
                          meta=jg.analyze_patterns(pats, k))
    sol_t, sol_j = out_t["solution"].numpy(), np.asarray(out_j["solution"])
    np.testing.assert_array_equal(out_t["osd0"].numpy(), np.asarray(out_j["osd0"]))
    np.testing.assert_array_equal(out_t["inconsistent"].numpy(),
                                  np.asarray(out_j["inconsistent"]))
    np.testing.assert_allclose(out_t["min_pm"].numpy(), np.asarray(out_j["min_pm"]),
                               rtol=1e-6)
    differ = np.nonzero((sol_t != sol_j).any(axis=1))[0]
    if jitter:
        assert differ.size == 0, differ
    llr64 = llr.astype(np.float64)
    for b in differ:
        for s in (sol_t, sol_j):
            np.testing.assert_array_equal((H @ s[b]) % 2, synd[b], err_msg=f"shot {b}")
        assert llr64 @ sol_t[b] == llr64 @ sol_j[b], b
    # the sweep found candidates better than OSD-0 for some shots
    assert (sol_t != out_t["osd0"].numpy()).any()
