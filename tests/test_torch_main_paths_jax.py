"""The port's plain path against the JAX package, per shot, on the
[[144,12,12]] paths whose failure gates in ``chip_smoke.py`` are the
port's own counts: the shortened ``OSDWindow`` decode (p=0.004) and GDG
(p=0.005), 12 rounds, (W, F) = (3, 1), f32, on the first 128 shots of the
seed-2024 samples that the smoke script decodes (16384 and 8192 shots
drawn; a draw's first rows do not depend on its size); and the
whole-block decode of the 936x8784 DEM (``global_decoder``'s decoders,
both forms) on the first 64 shots of its 16384, and the shortened form on
all 16384 of seed 7, in 1024-shot ranges (~15 min each); and GDG at the
JAX package's parity knobs (bf16 messages and ring, spans form) on the
first 64 seed-7 shots of ``gdg-144-w3``.

Marked ``slow`` (tens of minutes on the CPU): run it with
``JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_main_paths_jax.py``.
On the window paths every shot must agree; an exact tie (ROADMAP section
3) would show there as a differing shot and fail the test. The global
cases allow a differing shot at an exact tie.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.circuits import sample_dem_numpy
from slidingwindowdecoder_torch.harness import circuit_level as tcl
from slidingwindowdecoder_torch.windows import pipeline as tp
from slidingwindowdecoder_tpu.decoders import BPOSD as JBPOSD
from slidingwindowdecoder_tpu.decoders import GDG as JGDG
from slidingwindowdecoder_tpu.decoders import OSDWindow as JOSDWindow
from slidingwindowdecoder_tpu.windows import pipeline as jp

pytestmark = pytest.mark.slow

SHOTS, SEED = 128, 2024


@contextlib.contextmanager
def _torch_threads(k):
    n = torch.get_num_threads()
    torch.set_num_threads(min(k, n))
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _samples(p, drawn):
    _, _, dem, plan = tcl.build_bb_window_experiment(144, p, 12, 3, 1)
    det, obs, _ = sample_dem_numpy(dem, drawn, np.random.default_rng(SEED))
    return plan, det[:SHOTS], obs[:SHOTS]


def _compare(plan, det, obs, factory_t, factory_j):
    with _torch_threads(4):
        out_t = tp.decode_sliding_window(plan, det, factory_t, device="cpu", verbose=False)
    ev_t = tp.evaluate_logical_errors(plan, det, obs, out_t["total_e_hat"], device="cpu")
    out_j = jp.decode_sliding_window(plan, det, factory_j, verbose=False)
    ev_j = jp.evaluate_logical_errors(plan, det, obs, out_j["total_e_hat"])
    e_t, e_j = out_t["total_e_hat"].numpy(), np.asarray(out_j["total_e_hat"])
    differ = np.nonzero((e_t != e_j).any(axis=1))[0]
    print(f"failed {ev_t['num_failed']} (JAX {ev_j['num_failed']}), flagged "
          f"{ev_t['num_flagged']} (JAX {ev_j['num_flagged']}), shots differing "
          f"{differ.tolist()}")
    assert not len(differ)
    assert (ev_t["num_failed"], ev_t["num_flagged"]) == (ev_j["num_failed"],
                                                          ev_j["num_flagged"])


def test_shortened_path_matches_jax_per_shot():
    plan, det, obs = _samples(0.004, 16384)
    kw = dict(pre_max_iter=8, post_max_iter=200, osd_method="osd_cs", osd_order=10)
    _compare(plan, det, obs, tcl.window_decoder_factory(True, device="cpu"),
             jp.CachingDecoderFactory(lambda s: JOSDWindow(s.mat, s.prior, **kw)))


def test_gdg_path_matches_jax_per_shot():
    plan, det, obs = _samples(0.005, 8192)
    _compare(plan, det, obs,
             tcl.gdg_window_factory(max_iter=8, ensemble_bucket=32, device="cpu"),
             jp.CachingDecoderFactory(lambda s: JGDG(
                 s.mat, s.prior, max_iter=8, ensemble_bucket=32,
                 ensemble_mode="host_loop")))


def test_gdg_bf16_path_matches_jax_per_shot():
    """``gdg-144-w3`` at the JAX package's GDG parity knobs (bf16 messages
    and ring, the spans form in 512-shot ensemble buckets,
    tools/validate_parity.py:88-112): the first 64 of 8192 seed-7 shots, the
    port's plain path against the JAX package. A differing shot must be an
    exact tie: both corrections give the same detector syndrome at equal
    f64 weight under the DEM's priors."""
    _, _, dem, plan = tcl.build_bb_window_experiment(144, 0.005, 12, 3, 1)
    det, obs, _ = sample_dem_numpy(dem, 8192, np.random.default_rng(7))
    det, obs = det[:64], obs[:64]
    kw = dict(max_iter=8, ensemble_bucket=512, ensemble_mode="spans",
              msg_dtype="bfloat16", hist_dtype="bfloat16")
    with _torch_threads(4):
        out_t = tp.decode_sliding_window(plan, det, tcl.gdg_window_factory(**kw, device="cpu"),
                                         device="cpu", verbose=False)
    out_j = jp.decode_sliding_window(
        plan, det, jp.CachingDecoderFactory(lambda s: JGDG(s.mat, s.prior, **kw)),
        verbose=False)
    ev_t = tp.evaluate_logical_errors(plan, det, obs, out_t["total_e_hat"], device="cpu")
    ev_j = jp.evaluate_logical_errors(plan, det, obs, out_j["total_e_hat"])
    e_t, e_j = out_t["total_e_hat"].numpy(), np.asarray(out_j["total_e_hat"])
    differ = np.nonzero((e_t != e_j).any(axis=1))[0]
    print(f"failed {ev_t['num_failed']} (JAX {ev_j['num_failed']}), flagged "
          f"{ev_t['num_flagged']} (JAX {ev_j['num_flagged']}), shots differing "
          f"{differ.tolist()}")
    llr = np.log((1 - dem.priors) / dem.priors).astype(np.float32).astype(np.float64)
    for b in differ:
        np.testing.assert_array_equal((plan.chk @ e_t[b]) % 2, (plan.chk @ e_j[b]) % 2)
        assert llr @ e_t[b] == llr @ e_j[b], b
    if not len(differ):
        assert (ev_t["num_failed"], ev_t["num_flagged"]) == (ev_j["num_failed"],
                                                              ev_j["num_flagged"])


@functools.cache
def _global_samples(seed):
    dem = tcl.build_bb_window_experiment(144, 0.004, 12, 3, 1)[2]
    det, obs, _ = sample_dem_numpy(dem, 16384, np.random.default_rng(seed))
    return dem, det, obs


# (shorten, seed, first shot, end): the smoke script's first 64 shots in
# both forms, and all 16384 seed-7 shots of the shortened form in 1024-shot
# ranges (the parity tools' seed, where its rate parts from the reference's)
GLOBAL_RANGES = [(False, SEED, 0, 64), (True, SEED, 0, 64), (True, 7, 0, 1024)] + [
    (True, 7, lo, lo + 1024) for lo in range(1024, 16384, 1024)]


@pytest.mark.parametrize("shorten, seed, lo, hi", GLOBAL_RANGES,
                         ids=["bposd", "shortened", "shortened-seed7-1024"] + [
                             f"shortened-seed7-{lo}-{hi}" for _, _, lo, hi in GLOBAL_RANGES[3:]])
def test_global_path_matches_jax_per_shot(shorten, seed, lo, hi):
    """``global_decoder``'s decoder on the whole DEM: the port's plain path
    and the JAX package's decoder, built as its ``global_decoder`` builds
    it, on shots [lo, hi) of a 16384-shot draw. A shot may differ only at
    an exact OSD-CS tie (both corrections satisfy the syndrome, equal f64
    weight). Prints both sides' failures and the differing shots."""
    dem, det, obs = _global_samples(seed)
    det, obs = det[lo:hi], obs[lo:hi]
    with _torch_threads(4):
        out_t = tcl.build_global_decoder(dem, shorten, device="cpu").core(torch.as_tensor(det))
    if shorten:
        jdec = JOSDWindow(dem.chk, dem.priors, pre_max_iter=8, post_max_iter=200,
                          osd_method="osd_cs", osd_order=10)
    else:
        jdec = JBPOSD(dem.chk, dem.priors, max_iter=200, osd_method="osd_cs", osd_order=10,
                      msg_dtype="bfloat16", phase_a_iters=16, bp_bucket=1024, osd_bucket=256)
    out_j = jdec.decode_batch_device(det)
    e_t, e_j = out_t["error"].numpy(), np.asarray(out_j["error"])
    failed = {k: int((((e @ dem.chk.T) % 2 != det).any(axis=1)
                      | ((e @ dem.obs.T) % 2 != obs).any(axis=1)).sum())
              for k, e in (("port", e_t), ("jax", e_j))}
    differ = np.nonzero((e_t != e_j).any(axis=1))[0]
    print(f"seed {seed} shots {lo}-{hi}: through OSD {int(out_t['osd_applied'].sum())}, "
          f"failed {failed}, shots differing {(differ + lo).tolist()}")
    np.testing.assert_array_equal(out_t["converged"].numpy(), np.asarray(out_j["converged"]))
    llr = np.log((1 - dem.priors) / dem.priors).astype(np.float32).astype(np.float64)
    for b in differ:
        for e in (e_t, e_j):
            np.testing.assert_array_equal((dem.chk @ e[b]) % 2, det[b], err_msg=f"shot {b}")
        assert llr @ e_t[b] == llr @ e_j[b], b + lo
