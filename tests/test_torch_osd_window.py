"""The port's ``OSDWindow``, the OSD-0 branch of ``osd_decode`` and the
shortened sliding-window pipeline against the JAX package (f32, CPU).

Inputs are made with numpy from a seed and fed to both sides. Errors,
convergence, iteration counts, OSD use and failure counts must be exact;
``min_pm`` (an f32 sum whose order differs between XLA and torch) agrees
within rtol 1e-6.

Exact OSD-CS ties (ROADMAP section 3) are kept out: the per-shot tests
draw non-uniform priors from a seed, so no two candidates have exactly
equal path metrics, and the pipeline tests run [[72]] W=2 at p=0.01 with
seed 2024, where no such tie decides a shot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.circuits import sample_dem_numpy
from slidingwindowdecoder_torch.codes import bb_code_by_n
from slidingwindowdecoder_torch.decoders import BPOSD, OSDWindow
from slidingwindowdecoder_torch.harness import circuit_level as tcl
from slidingwindowdecoder_torch.ops import gf2_solve as tgf
from slidingwindowdecoder_torch.windows import pipeline as tp
from slidingwindowdecoder_tpu.decoders import BPOSD as JBPOSD
from slidingwindowdecoder_tpu.decoders import OSDWindow as JOSDWindow
from slidingwindowdecoder_tpu.harness import circuit_level as jcl
from slidingwindowdecoder_tpu.ops import gf2_solve as jgf
from slidingwindowdecoder_tpu.windows import pipeline as jp


@pytest.fixture(scope="module")
def bb72():
    code, _, _ = bb_code_by_n(72)
    return code


@pytest.fixture(scope="module")
def smoke():
    _, _, dem, plan = tcl.build_bb_window_experiment(72, 0.01, 3, 2, 1)
    det, obs, _ = sample_dem_numpy(dem, 128, np.random.default_rng(2024))
    return plan, det, obs


def _hx_inputs(code, seed, p, shots):
    rng = np.random.default_rng(seed)
    probs = p * (0.75 + 0.5 * rng.random(code.N))
    errs = (rng.random((shots, code.N)) < probs).astype(np.uint8)
    return probs, ((errs @ code.hx.T) % 2).astype(np.uint8)


def _assert_results_equal(rt, rj):
    for k in ("error", "converged", "iterations", "osd_applied"):
        np.testing.assert_array_equal(getattr(rt, k), getattr(rj, k), err_msg=k)
    np.testing.assert_allclose(rt.min_pm, rj.min_pm, rtol=1e-6)


@pytest.mark.parametrize("method,order", [("osd_0", 0), ("osd_cs", 4)])
@pytest.mark.parametrize("new_n", [None, 60])
def test_osd_window_matches_jax(bb72, method, order, new_n):
    """Per shot on the [[72]] hx, 128 shots over 32-shot buckets: pre-BP,
    shortening + peel + post-BP, and OSD all give JAX's results."""
    probs, synds = _hx_inputs(bb72, 7, 0.05, 128)
    kw = dict(pre_max_iter=4, post_max_iter=20, osd_method=method, osd_order=order,
              new_n=new_n, bucket=32, osd_bucket=32)
    rt = OSDWindow(bb72.hx, probs, device="cpu", **kw).decode_batch(synds)
    rj = JOSDWindow(bb72.hx, probs, **kw).decode_batch(synds)
    assert 0 < rj.osd_applied.sum() < len(synds)
    assert 0 < rj.converged.sum()
    _assert_results_equal(rt, rj)


def test_osd_window_counts_and_padding(bb72):
    """``core`` reports how many shots entered post-BP, OSD, and ended
    dead; an awkward batch is padded to a bucket multiple and trimmed."""
    probs, synds = _hx_inputs(bb72, 3, 0.05, 100)
    dec = OSDWindow(bb72.hx, probs, device="cpu", pre_max_iter=4, post_max_iter=20,
                    osd_method="osd_cs", osd_order=4, new_n=60, bucket=32, osd_bucket=32)
    out = dec.core(torch.from_numpy(synds))
    counts = out["counts"]
    assert counts["osd"] == int(out["osd_applied"].sum()) > 0
    assert counts["osd"] + counts["dead"] <= counts["post_bp"] < len(synds)
    # every shot that ran past pre-BP entered post-BP
    assert int((out["iterations"] > 4).sum()) <= counts["post_bp"]
    full = dec.decode_batch(synds)
    assert full.error.shape == (100, bb72.N)
    np.testing.assert_array_equal(full.error, out["error"].numpy())
    np.testing.assert_array_equal(dec.decode(synds[5]), full.error[5])


def test_osd0_branch_bit_exact(smoke):
    """The OSD-0 branch of ``osd_decode`` (stable argsort of the
    reliability, integer-order elimination, OSD-0 path metric) against
    the JAX branch, on a window PCM with tied and distinct keys: solution
    bit-exact, path metric within rtol 1e-6."""
    plan, det, _ = smoke
    spec = plan.windows[0]
    H = spec.mat
    m, n = H.shape
    rank = tgf.gf2_rank_packed(H)
    rng = np.random.default_rng(5)
    synd = det[:64, spec.row_start:spec.row_end].astype(np.uint8)
    rel = rng.standard_normal((64, n)).astype(np.float32)
    rel[::2] = np.round(rel[::2])  # many exact ties, broken by column id
    llr = np.log((1 - spec.prior) / spec.prior).astype(np.float32)
    out_t = tgf.osd_decode(
        torch.as_tensor(tgf.pack_rows_host(H).view(np.int32)), torch.from_numpy(synd),
        torch.from_numpy(rel), torch.from_numpy(llr), m=m, n=n, rank=rank, k=n - rank,
        meta={"kind": "none"})
    out_j = jgf.osd_decode(
        jnp.asarray(jgf.pack_rows_host(H)), jnp.asarray(synd), jnp.asarray(rel),
        jnp.asarray(llr), np.zeros((0, n - rank), np.uint8), m=m, n=n, rank=rank,
        k=n - rank, meta={"kind": "none"})
    for k in ("solution", "osd0", "inconsistent"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]), err_msg=k)
    assert out_t["inconsistent"].any() or out_t["solution"].any()
    # the OSD-0 path metric is an f32 sum over n columns in each side's order
    np.testing.assert_allclose(out_t["min_pm"].numpy(), np.asarray(out_j["min_pm"]),
                               rtol=1e-6)


def test_bposd_osd0_matches_jax(smoke):
    """``BPOSD(osd_method="osd_0")`` goes through the same OSD-0 branch."""
    plan, det, _ = smoke
    spec = plan.windows[0]
    synd = det[:, spec.row_start:spec.row_end]
    kw = dict(max_iter=20, osd_method="osd_0", phase_a_iters=6, phase_b_spans=None,
              bp_bucket=32, osd_bucket=32)
    rt = BPOSD(spec.mat, spec.prior, device="cpu", **kw).decode_batch(synd)
    rj = JBPOSD(spec.mat, spec.prior, **kw).decode_batch(synd)
    assert 0 < rj.osd_applied.sum() < len(synd)
    _assert_results_equal(rt, rj)


def test_shortened_pipeline_matches_jax(smoke):
    """[[72]] x3 rounds, W=2, p=0.01, seed 2024, 128 shots, OSD-CS order 2:
    the shortened window pipeline gives JAX's corrections and counts."""
    plan, det, obs = smoke
    kw = dict(pre_max_iter=8, post_max_iter=30, osd_method="osd_cs", osd_order=2)
    ft = tp.CachingDecoderFactory(lambda s: OSDWindow(s.mat, s.prior, device="cpu", **kw))
    out_t = tp.decode_sliding_window(plan, det, ft, device="cpu", verbose=False,
                                     sync_per_window=True)
    ev_t = tp.evaluate_logical_errors(plan, det, obs, out_t["total_e_hat"], device="cpu")
    fj = jp.CachingDecoderFactory(lambda s: JOSDWindow(s.mat, s.prior, **kw))
    out_j = jp.decode_sliding_window(plan, det, fj, verbose=False, sync_per_window=True)
    ev_j = jp.evaluate_logical_errors(plan, det, obs, out_j["total_e_hat"])

    assert min(c["post_bp"] for c in out_t["window_counts"]) > 0
    assert sum(c["osd"] for c in out_t["window_counts"]) > 0
    assert out_t["window_nonconverged"] == out_j["window_nonconverged"]
    assert out_t["window_flagged"] == out_j["window_flagged"]
    np.testing.assert_array_equal(out_t["total_e_hat"].numpy(),
                                  np.asarray(out_j["total_e_hat"]))
    assert ev_t["num_failed"] == ev_j["num_failed"]
    assert ev_t["num_flagged"] == ev_j["num_flagged"]


@pytest.mark.parametrize("shorten", [False, True])
def test_sliding_window_decoder_matches_jax(shorten):
    """The port's ``sliding_window_decoder`` against JAX's at a small size
    ([[72]] x2, W=2, p=0.01, 64 shots, max_iter 20, OSD-CS order 2, seed
    2024): failures, flags and the per-window flagged counts equal."""
    kw = dict(N=72, p=0.01, num_repeat=2, num_shots=64, max_iter=20, W=2, F=1,
              osd_order=2, shorten=shorten, seed=2024, verbose=False)
    rt = tcl.sliding_window_decoder(device="cpu", **kw)
    rj = jcl.sliding_window_decoder(**kw)
    for k in ("num_failed", "num_flagged", "window_flagged", "num_windows", "ler"):
        assert rt[k] == rj[k], k
    assert rt["num_failed"] > 0


def test_osd_window_order_bound(bb72):
    with pytest.raises(ValueError, match="osd_order"):
        OSDWindow(bb72.hx, np.full(bb72.N, 0.01), osd_method="osd_cs", osd_order=100,
                  device="cpu")
    with pytest.raises(ValueError, match="unknown osd_method"):
        OSDWindow(bb72.hx, np.full(bb72.N, 0.01), osd_method="osd_x", device="cpu")
    dec = OSDWindow(bb72.hx, np.full(bb72.N, 0.01), osd_method="osd_e", osd_order=3,
                    device="cpu")
    assert dec.patterns.shape == (7, dec.k)  # 2**3 - 1 candidates


def test_osd_window_candidates_and_cs_beats_osd0(bb72):
    """new_n < n: the OSD-CS candidate list has exactly k + order*(order-1)/2
    patterns over k = new_n - rank free columns; where OSD ran, its output
    satisfies the syndrome and pm(OSD-CS) <= pm(OSD-0) per shot."""
    new_n, order = 60, 6
    probs, synds = _hx_inputs(bb72, 11, 0.05, 64)
    kw = dict(pre_max_iter=4, post_max_iter=8, new_n=new_n, bucket=16, osd_bucket=16)
    dec = OSDWindow(bb72.hx, probs, device="cpu", osd_method="osd_cs", osd_order=order, **kw)
    k = new_n - dec.rank
    assert dec.k == k
    assert dec.patterns.shape == (k + order * (order - 1) // 2, k)
    w = dec.patterns.sum(axis=1)
    assert (w[:k] == 1).all() and (w[k:] == 2).all()

    res = dec.decode_batch(synds)
    res0 = OSDWindow(bb72.hx, probs, device="cpu", osd_method="osd_0", **kw).decode_batch(synds)
    applied = res.osd_applied
    assert applied.any()
    resid = (res.error.astype(np.int64) @ bb72.hx.T + synds) % 2
    assert not resid[applied].any()
    both = applied & res0.osd_applied
    assert both.any() and (res.min_pm[both] <= res0.min_pm[both] + 1e-4).all()
