"""The port's ``BPGD`` (``decoders.bpgd``) against the JAX package (f32,
CPU).

Inputs are code-capacity syndromes of the bb72 ``hx`` (36x72), made with
numpy from a seed and fed to both sides. Errors, convergence and iteration
counts must be equal on every shot; ``min_pm`` agrees within rtol 1e-6 (an
f32 sum in another order). At min-sum factor 1.0 the JAX side runs its XLA
CN stage; at ``gd_factor=0.8`` XLA on the CPU may contract ``post -
alpha * mag`` into an FMA (tests/test_bp_pallas.py:108-115), so the JAX
side runs its CN stage as the Pallas kernel in interpret mode, a custom
call XLA cannot contract, at a batch of 128 shots (its lane width).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.codes import bb_code_by_n
from slidingwindowdecoder_torch.decoders import BPGD
from slidingwindowdecoder_torch.decoders import bpgd as tbpgd
from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.ops import bp as tbp
from slidingwindowdecoder_torch.ops import bp_cuda
from slidingwindowdecoder_torch.ops.decimation import init_decimation_state, peel, vn_set_values
from slidingwindowdecoder_tpu.decoders import BPGD as JBPGD
from slidingwindowdecoder_tpu.decoders import bpgd as jbpgd
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays
from slidingwindowdecoder_tpu.ops import bp as jbp

P = 0.06


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


def _inputs(code, priors, shots, seed=5, p=P):
    rng = np.random.default_rng(seed)
    probs = p * (0.75 + 0.5 * rng.random(code.N)) if priors == "jittered" else np.full(code.N, p)
    errs = (rng.random((shots, code.N)) < probs).astype(np.uint8)
    return probs, ((errs @ code.hx.T) % 2).astype(np.uint8)


def _assert_equal(rt, rj):
    for k in ("error", "converged", "iterations"):
        np.testing.assert_array_equal(getattr(rt, k), getattr(rj, k), err_msg=k)
    np.testing.assert_allclose(rt.min_pm, rj.min_pm, rtol=1e-6)


SMALL = dict(max_iter=8, max_step=20, new_n=None, bucket=16, row_bucket=16,
             decim_spans=(4, 4, 12))


@pytest.mark.parametrize("mode", ["loop", "spans"])
@pytest.mark.parametrize("priors", ["jittered", "uniform"])
def test_bpgd_matches_jax(bb72, priors, mode):
    """Factor 1.0, 64 shots, 16-shot buckets, shortened to new_n = 2m = n:
    per shot equal to JAX, in both modes; uniform priors give exact ties of
    |posterior|, which both argmaxes break to the first VN."""
    probs, synds = _inputs(bb72, priors, 64)
    rj = JBPGD(bb72.hx, probs, mode=mode, **SMALL).decode_batch(synds)
    rt = BPGD(bb72.hx, probs, mode=mode, device="cpu", **SMALL).decode_batch(synds)
    assert (rj.iterations > SMALL["max_iter"]).sum() >= 16  # the decimation ran
    assert 0 < (~rj.converged).sum()
    _assert_equal(rt, rj)


@pytest.mark.parametrize("mode", ["loop", "spans"])
def test_bpgd_factor_08_matches_jax(bb72, mode):
    """The ``Misc.ipynb`` cell 10 knobs at a small size: no pre-BP
    (``max_iter=0``), 12 iterations a step at ``gd_factor=0.8``, new_n = n,
    jittered priors around p=0.1, 128 shots in one bucket; equal decisions
    against the JAX CN stage as an interpret-mode Pallas kernel."""
    probs, synds = _inputs(bb72, "jittered", 128, seed=9, p=0.1)
    kw = dict(max_iter=0, max_iter_per_step=12, gd_factor=0.8, max_step=bb72.N,
              new_n=bb72.N, bucket=128, row_bucket=128, mode=mode)
    rj = JBPGD(bb72.hx, probs, cn_engine="pallas_interpret", **kw).decode_batch(synds)
    before = tbp_calls()
    rt = BPGD(bb72.hx, probs, device="cpu", **kw).decode_batch(synds)
    assert not (rj.iterations == 0).all()
    assert 0 < rj.converged.sum() < len(synds)
    _assert_equal(rt, rj)
    # the bursts ran their plain loop: one call a step of a bucket with rows left
    assert tbp_calls() > before


def tbp_calls():
    return bp_cuda.bp_span.plain_calls


def test_decode_bp_no_iteration(bb72):
    """``max_iter=0``: ``decode_bp`` runs nothing (no call of the fused
    kernel's wrapper, so no launch on the card) and gives what JAX gives:
    no shot converged, ``llr_sum`` all zero."""
    probs, synds = _inputs(bb72, "jittered", 16)
    llr = np.log((1 - probs) / probs).astype(np.float32)
    g = compile_graph(bb72.hx)
    before = bp_cuda.bp_span.plain_calls
    out_t = tbp.decode_bp(graph_tensors(g, "cpu"), llr, torch.from_numpy(synds), num_iter=0)
    assert bp_cuda.bp_span.plain_calls == before
    out_j = jbp.decode_bp(graph_device_arrays(g), llr, jnp.asarray(synds), num_iter=0)
    assert not np.asarray(out_j["converged"]).any()
    for k in ("llr_sum", "error", "converged", "iterations"):
        np.testing.assert_array_equal(np.asarray(out_t[k]), np.asarray(out_j[k]), err_msg=k)
    assert not out_t["llr_sum"].any()


def test_bpgd_loop_and_spans_bit_equal(bb72):
    """The port's two forms on the JAX test's inputs (tests/test_gdg.py:
    135-152): 48 shots at p=0.04, uniform priors, a 16-row bucket whose
    boundaries straddle pre-converged rows and spans (4, 4, 12)."""
    rng = np.random.default_rng(1234)
    errs = (rng.random((48, bb72.N)) < 0.04).astype(np.uint8)
    synds = (errs @ bb72.hx.T) % 2
    kw = dict(max_iter=8, max_step=20, new_n=bb72.N, bucket=16, device="cpu")
    r_loop = BPGD(bb72.hx, np.full(bb72.N, 0.04), mode="loop", **kw).decode_batch(synds)
    r_spans = BPGD(bb72.hx, np.full(bb72.N, 0.04), mode="spans", decim_spans=(4, 4, 12),
                   row_bucket=16, **kw).decode_batch(synds)
    for k in ("error", "converged", "iterations", "min_pm"):
        np.testing.assert_array_equal(getattr(r_loop, k), getattr(r_spans, k), err_msg=k)
    assert 0.25 < r_loop.converged.mean() < 1.0


@pytest.mark.parametrize("max_step", [20, 100, 882])
def test_default_bpgd_spans_match_jax(max_step):
    assert tbpgd.default_bpgd_spans(max_step) == jbpgd.default_bpgd_spans(max_step)
    assert sum(tbpgd.default_bpgd_spans(max_step)) == max_step


def test_burst_ring_slice_equals_jax_where_read(bb72):
    """``hist_update="slice"``: JAX writes the ring slot for every row and
    VN, the port only for active rows' undecided VNs. ``_bpgd_step`` reads
    slot 3 only there, for the rows still active after the burst; on those
    entries the port's ring equals JAX's, and it keeps its entry values
    elsewhere."""
    probs, synds = _inputs(bb72, "jittered", 32, seed=3)
    llr = np.log((1 - probs) / probs).astype(np.float32)
    g = compile_graph(bb72.hx)
    gt, gj = graph_tensors(g, "cpu"), graph_device_arrays(g)
    B, n = synds.shape[0], bb72.N
    s = torch.from_numpy(synds)
    state = init_decimation_state(gt, s)
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random((B, n)) < 0.3)
    state = peel(gt, *vn_set_values(gt, *state, mask, torch.zeros((B, n), dtype=torch.int8)))
    vn, cn = state[0], state[1]
    done = torch.from_numpy(rng.random(B) < 0.25)
    ring0 = torch.from_numpy(rng.standard_normal((n, 4, B)).astype(np.float32))
    err0 = torch.zeros((B, n), dtype=torch.int8)
    kw = dict(num_iter=12, alpha=1.0, clip=50.0, io_layout="slot_major",
              hist_update="slice")
    out_t = tbp.bp_run(gt, tbp.bp_init_messages_sm(gt, torch.from_numpy(llr), B), llr, s,
                       ring0.clone(), err0, done, torch.zeros(B, dtype=torch.int32),
                       vn_state=vn, cn_state=cn, masked=True, **kw)
    out_j = jbp.bp_run(gj, jbp.bp_init_messages_sm(gj, llr, B), llr, jnp.asarray(synds),
                       jnp.asarray(vn.numpy()), jnp.asarray(cn.numpy()),
                       jnp.asarray(ring0.numpy()), jnp.asarray(err0.numpy()),
                       jnp.asarray(done.numpy()), jnp.zeros(B, jnp.int32), **kw)
    ring_t, ring_j = out_t[1].numpy(), np.asarray(out_j[1])
    for k in (2, 3, 4):
        np.testing.assert_array_equal(np.asarray(out_t[k]), np.asarray(out_j[k]))
    still = ~out_t[3].numpy()
    read = (vn.numpy() == -1).T[:, :] & still[None, :]  # [n, B]
    assert read.sum() > 100
    np.testing.assert_array_equal(ring_t[:, 3][read], ring_j[:, 3][read])
    entry_done = done.numpy()
    np.testing.assert_array_equal(ring_t[:, :, entry_done], ring0.numpy()[:, :, entry_done])


def test_bpgd_needs_a_card_by_default(bb72, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BPGD(bb72.hx, np.full(bb72.N, 0.05))


def test_bpgd_rejects_bad_arguments(bb72):
    with pytest.raises(ValueError, match="decim_spans"):
        BPGD(bb72.hx, np.full(bb72.N, 0.05), max_step=20, decim_spans=(4, 4), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        BPGD(bb72.hx, np.full(bb72.N, 0.05), mode="fused", device="cpu")
