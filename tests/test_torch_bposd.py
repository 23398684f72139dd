"""The port's BPOSD decoder and window pipeline against the JAX package,
f32 at the smoke knobs of ``bench.py --smoke`` ([[72]] x3 rounds, W=2,
128 shots, max_iter 30, OSD-CS order 2).

Known limit (ROADMAP section 3): when two OSD-CS candidates have exactly
equal path metrics (identical window columns with equal priors), the
winner follows the f32 rounding of each side's sum order, so the two
packages can pick different, equally likely corrections. At p=0.01 and
seed 2024 no such tie decides a shot of the pipeline; at p=0.006 and 0.008
one shot of the last window differs that way.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slidingwindowdecoder_torch.circuits import sample_dem_numpy
from slidingwindowdecoder_torch.decoders import BPOSD
from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
from slidingwindowdecoder_torch.windows import pipeline as tp
from slidingwindowdecoder_tpu.decoders import BPOSD as JBPOSD
from slidingwindowdecoder_tpu.windows import pipeline as jp

SMOKE = dict(max_iter=30, osd_method="osd_cs", osd_order=2, phase_a_iters=None,
             phase_b_spans=None, msg_dtype="float32")


@pytest.fixture(scope="module")
def smoke():
    _, _, dem, plan = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    det, obs, _ = sample_dem_numpy(dem, 128, np.random.default_rng(2024))
    return plan, det, obs


def test_pipeline_matches_jax(smoke):
    plan, det, obs = smoke
    ft = tp.CachingDecoderFactory(lambda s: BPOSD(s.mat, s.prior, device="cpu", **SMOKE))
    out_t = tp.decode_sliding_window(plan, det, ft, device="cpu", verbose=False,
                                     sync_per_window=True)
    ev_t = tp.evaluate_logical_errors(plan, det, obs, out_t["total_e_hat"], device="cpu")

    fj = jp.CachingDecoderFactory(lambda s: JBPOSD(s.mat, s.prior, **SMOKE))
    out_j = jp.decode_sliding_window(plan, det, fj, verbose=False, sync_per_window=True)
    ev_j = jp.evaluate_logical_errors(plan, det, obs, out_j["total_e_hat"])

    # every window sends shots to OSD
    assert min(out_j["window_nonconverged"]) > 0
    assert out_t["window_nonconverged"] == out_j["window_nonconverged"]
    assert out_t["window_flagged"] == out_j["window_flagged"]
    np.testing.assert_array_equal(out_t["total_e_hat"].numpy(),
                                  np.asarray(out_j["total_e_hat"]))
    np.testing.assert_array_equal(out_t["corrected_det"].numpy(),
                                  np.asarray(out_j["corrected_det"]))
    assert ev_t["num_failed"] == ev_j["num_failed"]
    assert ev_t["num_flagged"] == ev_j["num_flagged"]
    for k in ("flagged", "logical", "failed"):
        np.testing.assert_array_equal(ev_t[k], ev_j[k])


@pytest.mark.parametrize("reliability", ["last", "history_sum"])
def test_bposd_buckets_match_jax(smoke, reliability):
    """Phase A + two phase-B spans over 32-shot buckets + 32-shot OSD
    buckets: the compaction walks give JAX's per-shot results. (On window 1
    with ``history_sum`` one shot meets an exact OSD-CS tie, see above.)"""
    plan, det, _ = smoke
    spec = plan.windows[0]
    synd = det[:, spec.row_start:spec.row_end]
    kw = dict(SMOKE, phase_a_iters=6, phase_b_spans=(8, 16), bp_bucket=32,
              osd_bucket=32, reliability=reliability)
    rt = BPOSD(spec.mat, spec.prior, device="cpu", **kw).decode_batch(synd)
    rj = JBPOSD(spec.mat, spec.prior, **kw).decode_batch(synd)
    assert 0 < rj.osd_applied.sum() < len(synd)
    for k in ("error", "converged", "iterations", "osd_applied"):
        np.testing.assert_array_equal(getattr(rt, k), getattr(rj, k), err_msg=k)
    np.testing.assert_allclose(rt.min_pm, rj.min_pm, rtol=1e-6)


def test_decode_batch_pads_and_trims(smoke):
    """An awkward batch is padded to a bucket multiple and trimmed back;
    per-shot results do not depend on the batch around them."""
    plan, det, _ = smoke
    spec = plan.windows[0]
    synd = det[:100, spec.row_start:spec.row_end]
    dec = BPOSD(spec.mat, spec.prior, device="cpu", bp_bucket=32, osd_bucket=32,
                **dict(SMOKE, phase_a_iters=6))
    full = dec.decode_batch(synd)
    assert full.error.shape == (100, spec.mat.shape[1])
    part = dec.decode_batch(synd[:37])
    np.testing.assert_array_equal(full.error[:37], part.error)
    np.testing.assert_array_equal(dec.decode(synd[5]), full.error[5])


def test_divisor_bucket():
    from slidingwindowdecoder_torch.decoders.bposd import _divisor_bucket

    assert _divisor_bucket(5632, 2048) == 1408
    assert _divisor_bucket(16384, 1024) == 1024
    assert _divisor_bucket(7, 4) == 1


def test_gf2_matmul_exact():
    a = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (5, 300), np.uint8))
    b = np.random.default_rng(1).integers(0, 2, (300, 7)).astype(np.float32)
    ref = (a.numpy().astype(np.int64) @ b.astype(np.int64)) % 2
    np.testing.assert_array_equal(tp._gf2_matmul(a, torch.from_numpy(b)).numpy(), ref)


def test_unported_osd_methods_raise():
    H = np.array([[1, 1, 0], [0, 1, 1]], np.uint8)
    with pytest.raises(ValueError, match="not ported"):
        BPOSD(H, np.full(3, 0.1), osd_method="osd_e", device="cpu")
    dec = BPOSD(H, np.full(3, 0.1), osd_method="off", device="cpu", max_iter=5)
    res = dec.decode_batch(np.array([[1, 0]], np.uint8))
    assert not res.osd_applied.any()
    np.testing.assert_array_equal(res.error[0], [1, 0, 0])
