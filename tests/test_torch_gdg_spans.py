"""GDG's span-compacted ensemble (``ensemble_mode="spans"``) and GDG at the
code-capacity min-sum factor 0.625, against the port's host-stepped form
and the JAX package (f32, CPU).

Inputs are code-capacity syndromes of the bb72 ``hx`` at p=0.13 with
jittered priors (the inputs of ``test_torch_gdg.py``), made with numpy from
a seed. The spans form must give the host-stepped form's outputs bit for
bit: errors, convergence, iterations and ``min_pm``. Against JAX, errors,
convergence and iteration counts must be equal and ``min_pm`` agree within
rtol 1e-6. At factor 0.625 the JAX CN stage runs as the Pallas kernel in
interpret mode (XLA cannot contract it into an FMA,
tests/test_bp_pallas.py:108-115), so its batches are multiples of 128
columns.
"""

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.codes import bb_code_by_n
from slidingwindowdecoder_torch.decoders import GDG
from slidingwindowdecoder_torch.decoders import gdg as tgdg
from slidingwindowdecoder_tpu.decoders import GDG as JGDG
from slidingwindowdecoder_tpu.decoders import gdg as jgdg

# tests/test_gdg.py:241-313's knobs (22 branches, D_max 40)
KW = dict(max_iter=24, max_iter_per_step=6, max_step=40, max_tree_depth=3,
          max_side_depth=10, max_tree_branch_step=20, max_side_branch_step=20)
P = 0.13


@pytest.fixture(scope="module")
def bb72():
    code, _, _ = bb_code_by_n(72)
    return code


@pytest.fixture(autouse=True)
def one_thread():
    """The inputs are small, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _inputs(code, shots):
    rng = np.random.default_rng(7)
    probs = P * (0.75 + 0.5 * rng.random(code.N))
    errs = (rng.random((shots, code.N)) < probs).astype(np.uint8)
    return probs, ((errs @ code.hx.T) % 2).astype(np.uint8)


def _assert_equal(rt, ref, *, exact_pm):
    for k in ("error", "converged", "iterations"):
        np.testing.assert_array_equal(getattr(rt, k), getattr(ref, k), err_msg=k)
    if exact_pm:
        np.testing.assert_array_equal(rt.min_pm, ref.min_pm)
    else:
        np.testing.assert_allclose(rt.min_pm, ref.min_pm, rtol=1e-6)


@pytest.mark.parametrize("spans,row_bucket", [(None, 128), ((4, 4, 4, 4, 4, 20), 128),
                                              (None, 2048)],
                         ids=["default-spans", "no-activation-boundary", "one-bucket"])
@pytest.mark.parametrize("low_error_mode", [False, True])
def test_spans_bit_equal_hostloop(bb72, low_error_mode, spans, row_bucket):
    """64 shots in 16-shot ensemble buckets (352 columns), row buckets of
    88 columns (the largest divisor of 352 up to 128), at factor 1.0, or
    all 352 columns in one bucket (no compaction; spans with no unfinished
    column skipped). The user schedule misses the activation depths 3, 5,
    6, 7, 9, so it runs with no dormancy: every lane recomputes its
    prefix."""
    probs, synds = _inputs(bb72, 64)
    kw = dict(KW, low_error_mode=low_error_mode, ensemble_bucket=16, device="cpu")
    ref = GDG(bb72.hx, probs, ensemble_mode="host_loop", **kw).decode_batch(synds)
    dec = GDG(bb72.hx, probs, ensemble_mode="spans", ensemble_spans=spans,
              row_bucket=row_bucket, **kw)
    assert (dec._copy_plan is None) == (spans is not None)
    assert (ref.iterations > KW["max_iter"]).sum() >= 16  # the ensemble ran
    _assert_equal(dec.decode_batch(synds), ref, exact_pm=True)


def test_spans_compact_and_keep_dormant_lanes(bb72, monkeypatch):
    """The walk steps only buckets of unfinished columns, and a dormant
    lane is stepped from its activation depth on: at depth 0 only the main
    and tree lanes (8 of 22) are stepped, in 88-column buckets."""
    probs, synds = _inputs(bb72, 64)
    dec = GDG(bb72.hx, probs, ensemble_mode="spans", ensemble_bucket=16, row_bucket=128,
              device="cpu", **KW)
    seen, step = [], tgdg._ensemble_step

    def counted(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw):
        seen.append((d, carry["vn"].shape[1]))
        return step(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw)

    monkeypatch.setattr(tgdg, "_ensemble_step", counted)
    dec.core(torch.from_numpy(synds))
    widths = {w for _, w in seen}
    assert widths == {88}
    at0 = sum(w for d, w in seen if d == 0)
    buckets = -(-int(synds.any(axis=1).sum()) // 16)  # ensemble buckets, at most
    assert at0 <= buckets * 88 * -(-16 * 8 // 88)
    assert dec.ensemble_spans[0] == 3  # the tree-side lanes activate at depth 3


def test_one_bucket_spans_end_with_the_last_column(bb72, monkeypatch):
    """With every column in one row bucket the spans form skips the spans
    after the one in which the last column finished, as the host-stepped
    form stops: no step runs past depth 30 of 40 here."""
    probs, synds = _inputs(bb72, 64)
    dec = GDG(bb72.hx, probs, ensemble_mode="spans", ensemble_bucket=16, row_bucket=2048,
              device="cpu", **KW)
    seen, step = [], tgdg._ensemble_step

    def counted(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw):
        seen.append((d, carry["vn"].shape[1]))
        return step(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw)

    monkeypatch.setattr(tgdg, "_ensemble_step", counted)
    dec.core(torch.from_numpy(synds))
    assert {w for _, w in seen} == {16 * dec.NB}
    assert max(d for d, _ in seen) < 30


def test_spans_match_jax(bb72):
    """Against the JAX spans form at factor 1.0 (its XLA CN stage), with the
    aggressive decimation on (``low_error_mode=False``), 32 shots in one
    ensemble bucket, row buckets of 88 columns."""
    probs, synds = _inputs(bb72, 32)
    kw = dict(KW, low_error_mode=False, ensemble_bucket=16, ensemble_mode="spans",
              row_bucket=128)
    rj = JGDG(bb72.hx, probs, **kw).decode_batch(synds)
    rt = GDG(bb72.hx, probs, device="cpu", **kw).decode_batch(synds)
    assert (rj.iterations > KW["max_iter"]).sum() >= 8
    _assert_equal(rt, rj, exact_pm=False)


@pytest.mark.parametrize("low_error_mode", [False, True])
def test_gdg_factor_0625_matches_jax(bb72, low_error_mode):
    """The code-capacity factor: pre-BP and ensemble at min-sum factor
    0.625, 128 shots, 64-shot ensemble buckets (1408 columns). The JAX
    host-stepped form with its CN stage in interpret-mode Pallas against
    the port's host-stepped form and its spans form (row buckets of 128):
    errors, convergence (so the branch choice) and iterations equal."""
    probs, synds = _inputs(bb72, 128)
    kw = dict(KW, ms_scaling_factor=0.625, gdg_factor=0.625, low_error_mode=low_error_mode,
              ensemble_bucket=64)
    rj = JGDG(bb72.hx, probs, ensemble_mode="host_loop", cn_engine="pallas_interpret",
              **kw).decode_batch(synds)
    assert (rj.iterations > KW["max_iter"]).sum() >= 32
    for mode in ("host_loop", "spans"):
        rt = GDG(bb72.hx, probs, ensemble_mode=mode, row_bucket=128, device="cpu",
                 **kw).decode_batch(synds)
        _assert_equal(rt, rj, exact_pm=False)


@pytest.mark.parametrize("knobs", [(25, 3, 10, 10, 10), (40, 4, 20, 30, 20),
                                   (80, 4, 20, 60, 60)],
                         ids=["sliding-window", "cc-288", "cc-882"])
def test_default_spans_match_jax(knobs):
    """The span schedules of the GDG parity rows: the sliding-window
    defaults, and the code-capacity rows on [[288]] and [[882]]
    (tools/validate_parity.py:168-177, :385-390)."""
    t = tgdg.build_branch_tables(*knobs)
    args = (t["D_max"], t["budget"].tolist())
    assert (tgdg.default_spans(*args, activations=t["copy_at"])
            == jgdg.default_spans(*args, activations=t["copy_at"]))
    dec = GDG(np.eye(4, 8, dtype=np.uint8) | np.eye(4, 8, 4, dtype=np.uint8),
              np.full(8, 0.1), max_step=knobs[0], max_tree_depth=knobs[1],
              max_side_depth=knobs[2], max_tree_branch_step=knobs[3],
              max_side_branch_step=knobs[4], ensemble_mode="spans", device="cpu")
    assert sum(dec.ensemble_spans) == dec.D_max and dec._copy_plan is not None


def test_spans_schedule_must_sum_to_depth(bb72):
    with pytest.raises(ValueError, match="D_max"):
        GDG(bb72.hx, np.full(bb72.N, 0.05), ensemble_mode="spans", ensemble_spans=(4, 4),
            device="cpu")
