"""GDG's serial work queue (``GDG(multi_thread=False)``, ``gdg_serial``)
against the JAX package and the literal pure-Python port of the
reference's queue (``tests/gdg_oracle.py``), on the CPU.

Inputs are bb72 ``hx`` syndromes made with numpy from a seed. Against the
JAX ``gdg_serial`` on the same shortened state: with jittered priors every
output equal per shot, the queue trace included, and ``min_pm`` within
rtol 1e-6 (the port's exact f64 path metric against JAX's f32 sum).
Against the oracle, as ``tests/test_gdg.py::test_gdg_serial_order_oracle``
runs the JAX function: the queue pushes, the explored pattern, convergence,
the error and ``min_pm`` within rtol 1e-4.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.codes import bb_code_by_n
from slidingwindowdecoder_torch.decoders import GDG
from slidingwindowdecoder_torch.decoders import gdg as tgdg
from slidingwindowdecoder_torch.ops import bp as tbp
from slidingwindowdecoder_tpu.decoders import GDG as JGDG
from slidingwindowdecoder_tpu.decoders import gdg as jgdg
from slidingwindowdecoder_tpu.ops import bp as jbp

sys.path.insert(0, str(Path(__file__).parent))
from gdg_oracle import gdg_serial_oracle  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """The inputs are small, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bb72():
    code, _, _ = bb_code_by_n(72)
    return code


TRACE = ("q_guess", "q_val", "q_depth", "q_used", "explored", "min_conv_depth")


def _serial_both(code, probs, synds, kw):
    """Pre-BP and the shortened state on each side, then each side's
    ``gdg_serial`` on its own state. Returns (port outputs, JAX outputs,
    pre-BP convergence), as numpy."""
    knobs = dict(num_iter=kw["max_iter_per_step"], max_step=kw["max_step"],
                 max_tree_depth=kw["max_tree_depth"], max_side_depth=kw["max_side_depth"],
                 max_side_branch_step=kw["max_side_branch_step"], alpha=1.0, clip=50.0,
                 low_error_mode=kw["low_error_mode"])
    dt = GDG(code.hx, probs, device="cpu", **kw)
    s_t = torch.from_numpy(synds)
    pre_t = tbp.decode_bp(dt.garr, dt._llr_dev, s_t, num_iter=kw["max_iter"])
    out_t = tgdg.gdg_serial(dt.garr, dt._llr_dev, s_t, *_order_last(
        dt._shorten_state(s_t, pre_t["llr_sum"])), max_guess=dt.max_guess, **knobs)
    dj = JGDG(code.hx, probs, **kw)
    s_j = jnp.asarray(synds)
    pre_j = jbp.decode_bp(dj.garr, dj._llr_dev, s_j, num_iter=kw["max_iter"], alpha=1.0,
                          clip=50.0)
    out_j = jgdg.gdg_serial(dj.garr, dj._llr_dev, s_j, *_order_last(
        dj._shorten_state(s_j, pre_j["llr_sum"])), max_guess=dj.max_guess, **knobs)
    assert dt.max_guess == dj.max_guess
    np.testing.assert_array_equal(np.asarray(pre_t["converged"]),
                                  np.asarray(pre_j["converged"]))
    return ({k: np.asarray(v) for k, v in out_t.items()},
            {k: np.asarray(v) for k, v in out_j.items()}, np.asarray(pre_j["converged"]),
            np.asarray(pre_j["llr_sum"]))


def _order_last(state):
    """``_shorten_state``'s (vn, cn, deg, dead, rank) as ``gdg_serial``'s
    (rank, vn, cn, deg, dead)."""
    vn, cn, cd, dead, rank = state
    return rank, vn, cn, cd, dead


# tests/test_gdg.py:241-313's knobs, as the ensemble tests run them
KW = dict(max_iter=24, max_iter_per_step=6, max_step=40, max_tree_depth=3,
          max_side_depth=10, max_tree_branch_step=20, max_side_branch_step=20,
          multi_thread=False)


@pytest.mark.parametrize("low_error_mode", [False, True])
def test_gdg_serial_matches_jax(bb72, low_error_mode):
    """bb72 at p=0.13 with jittered priors, seed 7, 64 shots: every output
    of ``gdg_serial`` equal per shot, the queue trace included."""
    rng = np.random.default_rng(7)
    probs = 0.13 * (0.75 + 0.5 * rng.random(bb72.N))
    errs = (rng.random((64, bb72.N)) < probs).astype(np.uint8)
    synds = ((errs @ bb72.hx.T) % 2).astype(np.uint8)
    out_t, out_j, pre_conv, _ = _serial_both(bb72, probs, synds,
                                             dict(KW, low_error_mode=low_error_mode))
    assert (~pre_conv).sum() >= 16 and (out_j["q_used"][~pre_conv] > 0).all()
    assert out_j["explored"].sum() >= 32  # phase 2 ran side branches
    for k in ("error", "converged", "iterations", *TRACE):
        np.testing.assert_array_equal(out_t[k], out_j[k], err_msg=k)
    np.testing.assert_allclose(out_t["min_pm"], out_j["min_pm"], rtol=1e-6)


def test_gdg_serial_decode_matches_jax(bb72):
    """``GDG(multi_thread=False).decode_batch`` (pre-BP, 16-shot buckets of
    the non-converged shots, the serial queue) against JAX's, 64 shots of
    jittered priors: errors, convergence and iterations equal."""
    rng = np.random.default_rng(11)
    probs = 0.12 * (0.75 + 0.5 * rng.random(bb72.N))
    errs = (rng.random((64, bb72.N)) < probs).astype(np.uint8)
    synds = ((errs @ bb72.hx.T) % 2).astype(np.uint8)
    kw = dict(KW, ensemble_bucket=16)
    rj = JGDG(bb72.hx, probs, **kw).decode_batch(synds)
    rt = GDG(bb72.hx, probs, device="cpu", **kw).decode_batch(synds)
    assert (rj.iterations > KW["max_iter"]).sum() >= 16
    for k in ("error", "converged", "iterations"):
        np.testing.assert_array_equal(getattr(rt, k), getattr(rj, k), err_msg=k)
    np.testing.assert_allclose(rt.min_pm, rj.min_pm, rtol=1e-6)


def test_gdg_serial_order_oracle(bb72, rng):
    """The reference's serial queue, order-exact (tests/test_gdg.py:314-406
    with the port's ``gdg_serial``): p=0.06 uniform priors, 24 shots,
    ``low_error_mode=True``; per shot not converged by the pre-BP, the
    queue pushes (guess VN, anti-value, depth), the explored-vs-pruned
    pattern, convergence, the error and ``min_pm`` (rtol 1e-4)."""
    p = 0.06
    kw = dict(max_iter=12, max_iter_per_step=4, max_step=12, max_tree_depth=2,
              max_side_depth=6, max_side_branch_step=6, new_n=bb72.N,
              low_error_mode=True, multi_thread=False)
    shots = 24
    errs = (rng.random((shots, bb72.N)) < p).astype(np.uint8)
    synds = ((errs @ bb72.hx.T) % 2).astype(np.uint8)
    prior = np.full(bb72.N, p)
    dec = GDG(bb72.hx, prior, device="cpu", **kw)
    s = torch.from_numpy(synds)
    pre = tbp.decode_bp(dec.garr, dec._llr_dev, s, num_iter=kw["max_iter"])
    out = tgdg.gdg_serial(
        dec.garr, dec._llr_dev, s, *_order_last(dec._shorten_state(s, pre["llr_sum"])),
        num_iter=kw["max_iter_per_step"], max_step=kw["max_step"],
        max_tree_depth=kw["max_tree_depth"], max_side_depth=kw["max_side_depth"],
        max_side_branch_step=kw["max_side_branch_step"], max_guess=dec.max_guess,
        alpha=1.0, clip=50.0, low_error_mode=True)
    out = {k: v.numpy() for k, v in out.items()}
    pre_conv, llr_sum = pre["converged"].numpy(), pre["llr_sum"].numpy()

    n_checked = 0
    for k in range(shots):
        ref = gdg_serial_oracle(
            bb72.hx, prior, synds[k], max_iter=kw["max_iter"],
            max_iter_per_step=kw["max_iter_per_step"], max_step=kw["max_step"],
            max_tree_depth=kw["max_tree_depth"], max_side_depth=kw["max_side_depth"],
            max_side_branch_step=kw["max_side_branch_step"], new_n=bb72.N,
            low_error_mode=True,
            pre_override=dict(converged=bool(pre_conv[k]), llr_sum=llr_sum[k]))
        if ref["pre_converged"]:
            assert pre_conv[k], k
            continue
        assert not pre_conv[k], k
        n_checked += 1
        pushes = ref["pushes"]
        assert int(out["q_used"][k]) == len(pushes), (k, out["q_used"][k], pushes)
        for slot, (vn, val, depth) in enumerate(pushes):
            assert (int(out["q_guess"][k, slot]), int(out["q_val"][k, slot]),
                    int(out["q_depth"][k, slot])) == (vn, val, depth), (k, slot)
        assert [bool(out["explored"][k, s]) for s in range(len(pushes))] == ref["explored"]
        assert bool(out["converged"][k]) == ref["converged"], k
        if ref["converged"]:
            np.testing.assert_allclose(float(out["min_pm"][k]), ref["min_pm"], rtol=1e-4)
            np.testing.assert_array_equal(out["error"][k], ref["error"], err_msg=str(k))
    assert n_checked >= 5  # the trace comparison actually exercised
