"""The port's GDG (``decoders.gdg``) and ``sliding_window_gdg`` against the
JAX package (f32, CPU).

Inputs are made with numpy from a seed and fed to both sides; the JAX
side runs its host-stepped ensemble (``ensemble_mode="host_loop"``, which
its own tests hold bit-identical to the fused form). The min-sum factors
are 1.0, as on the sliding-window path: with 0.625 XLA on the CPU may
contract ``post - alpha * mag`` into an FMA, which moves history sums and
with them the guesses (tests/test_bp_pallas.py:109-125).

Errors, convergence and iteration counts must be equal per shot; ``min_pm``
agrees to rtol 1e-6 (the port sums path metrics exactly in f64, JAX in f32
in XLA's order). Where priors are uniform, two branches' corrections of
equal weight are exact ties that the two sums may break differently: a
shot may differ there only, with both corrections satisfying the syndrome
at equal f64 weight (as in ``test_torch_gf2.py::test_osd_cs_matches_jax``).
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
from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.harness import circuit_level as tcl
from slidingwindowdecoder_torch.ops import bp as tbp
from slidingwindowdecoder_tpu.decoders import GDG as JGDG
from slidingwindowdecoder_tpu.decoders import gdg as jgdg
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays
from slidingwindowdecoder_tpu.ops import bp as jbp

sys.path.insert(0, str(Path(__file__).parent))
from _torch_gdg_sw import torch_threads as _torch_threads  # noqa: E402
from _torch_gdg_sw import weight as _weight  # noqa: E402

# tests/test_gdg.py:241-313's knobs, at min-sum factor 1.0
KW = dict(max_iter=24, ms_scaling_factor=1.0, gdg_factor=1.0, max_iter_per_step=6,
          max_step=40, max_tree_depth=3, max_side_depth=10, max_tree_branch_step=20,
          max_side_branch_step=20)
SHOTS, P = 64, 0.13


@pytest.fixture(scope="module")
def bb72():
    code, _, _ = bb_code_by_n(72)
    return code


def _inputs(code, priors):
    """Code-capacity syndromes of the [[72]] hx at p=0.13 (half the shots
    then need the ensemble), with jittered or uniform priors."""
    rng = np.random.default_rng(7)
    probs = P * (0.75 + 0.5 * rng.random(code.N)) if priors == "jittered" else np.full(code.N, P)
    errs = (rng.random((SHOTS, code.N)) < probs).astype(np.uint8)
    return probs, ((errs @ code.hx.T) % 2).astype(np.uint8)


@pytest.fixture
def one_thread():
    """The bb72 inputs are small: more threads gain nothing there."""
    with _torch_threads(1):
        yield


@pytest.fixture(scope="module")
def jax_runs(bb72):
    """The JAX GDG on each (priors, low_error_mode) input, run once."""
    runs = {}
    for priors in ("jittered", "uniform"):
        probs, synds = _inputs(bb72, priors)
        for low in (False, True):
            runs[priors, low] = JGDG(bb72.hx, probs, low_error_mode=low, ensemble_bucket=16,
                                     ensemble_mode="host_loop", **KW).decode_batch(synds)
    return runs


@pytest.mark.parametrize("knobs", [(25, 3, 10, 10, 10), (40, 4, 20, 20, 20)])
def test_branch_tables_match_jax(knobs):
    """The defaults (22 branches, 25 steps) and a deeper tree (4, 20, 20,
    20): every array equal, dtypes included."""
    tt, tj = tgdg.build_branch_tables(*knobs), jgdg.build_branch_tables(*knobs)
    assert tt.keys() == tj.keys()
    for k in tt:
        np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)
        assert np.asarray(tt[k]).dtype == np.asarray(tj[k]).dtype, k
    if knobs[1] == 3:
        assert (tt["num_branches"], tt["D_max"]) == (22, 25)


@pytest.mark.usefixtures("one_thread")
def test_decode_bp_llr_sum_matches_jax(bb72):
    """The pre-BP of GDG (``decode_bp``, 24 iterations) on the GDG test
    inputs: ``llr_sum``, the key of the shortening sort and of the guess
    tie-break, is bit-equal to JAX's (slot-by-slot sum of the ring)."""
    probs, synds = _inputs(bb72, "jittered")
    llr = np.log((1 - probs) / probs).astype(np.float32)
    g = compile_graph(bb72.hx)
    out_t = tbp.decode_bp(graph_tensors(g, "cpu"), llr, torch.from_numpy(synds), num_iter=24)
    out_j = jbp.decode_bp(graph_device_arrays(g), llr, jnp.asarray(synds), num_iter=24)
    assert 0 < int(out_t["converged"].sum()) < SHOTS
    for k in ("llr_sum", "history", "error", "converged", "iterations"):
        np.testing.assert_array_equal(np.asarray(out_t[k]), np.asarray(out_j[k]), err_msg=k)


@pytest.mark.parametrize("low_error_mode", [False, True])
@pytest.mark.parametrize("priors", ["jittered", "uniform"])
@pytest.mark.usefixtures("one_thread")
def test_gdg_matches_jax(bb72, jax_runs, priors, low_error_mode):
    """Per shot against JAX, 64 shots over 16-shot buckets, with and
    without the aggressive decimation (``low_error_mode``)."""
    probs, synds = _inputs(bb72, priors)
    rj = jax_runs[priors, low_error_mode]
    rt = GDG(bb72.hx, probs, low_error_mode=low_error_mode, ensemble_bucket=16,
             device="cpu", **KW).decode_batch(synds)
    assert (rj.iterations > KW["max_iter"]).sum() >= SHOTS // 4  # the ensemble ran
    np.testing.assert_array_equal(rt.converged, rj.converged)
    differ = (rt.error != rj.error).any(axis=1)
    if priors == "jittered":
        assert not differ.any()
    llr = np.log((1 - probs) / probs)
    for i in np.nonzero(differ)[0]:  # exact ties only
        for e in (rt.error[i], rj.error[i]):
            np.testing.assert_array_equal((e.astype(np.int64) @ bb72.hx.T) % 2, synds[i])
        assert _weight(llr, rt.error[i]) == pytest.approx(_weight(llr, rj.error[i]), rel=1e-12)
    assert differ.sum() <= SHOTS // 4
    np.testing.assert_array_equal(rt.iterations, rj.iterations)
    np.testing.assert_allclose(rt.min_pm, rj.min_pm, rtol=1e-6)


@pytest.mark.usefixtures("one_thread")
def test_gdg_bucket_invariance_and_modes(bb72):
    """Per-shot results do not depend on ``ensemble_bucket`` (8 or 16), and
    the "fused" (``gdg_ensemble``, every step) and "host_loop" modes agree
    (every shot converges here, so no dead column shows)."""
    probs, synds = _inputs(bb72, "jittered")
    res = [GDG(bb72.hx, probs, ensemble_bucket=bk, ensemble_mode=mode, device="cpu",
               **KW).decode_batch(synds)
           for bk, mode in ((16, "fused"), (8, "fused"), (16, "host_loop"))]
    for r in res[1:]:
        for k in ("error", "converged", "iterations", "min_pm"):
            np.testing.assert_array_equal(getattr(r, k), getattr(res[0], k), err_msg=k)
    np.testing.assert_array_equal(GDG(bb72.hx, probs, device="cpu", **KW).decode(synds[3]),
                                  res[0].error[3])


@pytest.mark.parametrize("kw", [
    pytest.param(dict(ensemble_mode="spans", hist_dtype="bfloat16"), id="spans-bf16-ring"),
    pytest.param(dict(multi_thread=False), id="serial"),
    pytest.param(dict(hist_dtype="bfloat16"), id="bf16-ring"),
    pytest.param(dict(hist_dtype="float16"), id="float16-ring-raises"),
    pytest.param(dict(hist_dtype="int8", multi_thread=False), id="int8-ring-raises")])
def test_gdg_forms_and_ring_dtype(bb72, kw):
    """The bf16 history ring (host-stepped and spans) and the serial work
    queue construct and decode: 16 shots at p=0.05, every converged
    correction matching its syndrome. A ring dtype other than float32 or
    bfloat16 raises ``ValueError``."""
    probs = np.full(bb72.N, 0.05)
    if kw.get("hist_dtype") in ("float16", "int8"):
        with pytest.raises(ValueError, match="hist_dtype"):
            GDG(bb72.hx, probs, device="cpu", **kw)
        return
    rng = np.random.default_rng(3)
    errs = (rng.random((16, bb72.N)) < 0.05).astype(np.uint8)
    synds = ((errs @ bb72.hx.T) % 2).astype(np.uint8)
    with _torch_threads(1):
        res = GDG(bb72.hx, probs, device="cpu", **kw).decode_batch(synds)
    assert res.error.shape == (16, bb72.N) and res.converged.sum() >= 12
    conv = res.converged
    np.testing.assert_array_equal((res.error[conv].astype(np.int64) @ bb72.hx.T) % 2,
                                  synds[conv])


def test_gdg_entry_points_need_a_card_by_default(bb72, monkeypatch):
    """``device=None`` means the card: without one, ``GDG`` and
    ``sliding_window_gdg`` raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GDG(bb72.hx, np.full(bb72.N, 0.05))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcl.sliding_window_gdg(N=72, num_repeat=2, num_shots=4, W=2)


@pytest.mark.usefixtures("one_thread")
def test_ensemble_steps_stop_when_all_finished(bb72, monkeypatch):
    """The host-stepped ensemble reads one flag per step and stops after
    the step at whose end every column has finished, well before D_max
    here; each bucket's carry has 16 shots x 22 branch columns."""
    probs, synds = _inputs(bb72, "jittered")
    dec = GDG(bb72.hx, probs, ensemble_bucket=16, ensemble_mode="host_loop", device="cpu",
              **KW)
    seen, step = [], tgdg._ensemble_step

    def counted(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw):
        seen.append((d, carry["mv"].shape[2]))
        return step(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw)

    monkeypatch.setattr(tgdg, "_ensemble_step", counted)
    dec.core(torch.from_numpy(synds))
    depths = [d for d, _ in seen]
    assert depths[0] == 0 and max(depths) < dec.D_max - 10
    assert {bn for _, bn in seen} == {16 * dec.NB}
