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

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.circuits import sample_dem_numpy
from slidingwindowdecoder_torch.codes import bb_code_by_n
from slidingwindowdecoder_torch.decoders import GDG
from slidingwindowdecoder_torch.decoders import gdg as tgdg
from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.harness import circuit_level as tcl
from slidingwindowdecoder_torch.ops import bp as tbp
from slidingwindowdecoder_tpu.decoders import GDG as JGDG
from slidingwindowdecoder_tpu.decoders import gdg as jgdg
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays
from slidingwindowdecoder_tpu.harness import circuit_level as jcl
from slidingwindowdecoder_tpu.ops import bp as jbp

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


@contextlib.contextmanager
def _torch_threads(k):
    """At most ``k`` torch intra-op threads inside the block. Where the
    test workers share the cores, a decode of many small ops spends its
    time in threads waiting on each other: a 2-3 s bb72 decode took
    minutes, a 30 s sliding-window decode over ten."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(k, n))
    try:
        yield
    finally:
        torch.set_num_threads(n)


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


def _weight(llr, e):
    return float(np.asarray(e, np.float64) @ llr.astype(np.float64))


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
    the "fused" and "host_loop" modes (both host-stepped here) agree."""
    probs, synds = _inputs(bb72, "jittered")
    res = [GDG(bb72.hx, probs, ensemble_bucket=bk, ensemble_mode=mode, device="cpu",
               **KW).decode_batch(synds)
           for bk, mode in ((16, "fused"), (8, "fused"), (16, "host_loop"))]
    for r in res[1:]:
        for k in ("error", "converged", "iterations", "min_pm"):
            np.testing.assert_array_equal(getattr(r, k), getattr(res[0], k), err_msg=k)
    np.testing.assert_array_equal(GDG(bb72.hx, probs, device="cpu", **KW).decode(synds[3]),
                                  res[0].error[3])


@pytest.mark.parametrize("kw,match", [
    # the spans form is ported; its bfloat16 history ring is not
    pytest.param(dict(ensemble_mode="spans", hist_dtype="bfloat16"), "float32",
                 id="kw0-spans"),
    (dict(multi_thread=False), "gdg_serial"), (dict(hist_dtype="bfloat16"), "float32")])
def test_gdg_unported_forms_raise(bb72, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        GDG(bb72.hx, np.full(bb72.N, 0.05), device="cpu", **kw)


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
    dec = GDG(bb72.hx, probs, ensemble_bucket=16, device="cpu", **KW)
    seen, step = [], tgdg._ensemble_step

    def counted(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw):
        seen.append((d, carry["mv"].shape[2]))
        return step(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw)

    monkeypatch.setattr(tgdg, "_ensemble_step", counted)
    dec.core(torch.from_numpy(synds))
    depths = [d for d, _ in seen]
    assert depths[0] == 0 and max(depths) < dec.D_max - 10
    assert {bn for _, bn in seen} == {16 * dec.NB}


SW = dict(N=72, p=0.01, num_repeat=3, num_shots=128, W=2, F=1, max_iter=8, seed=2024,
          verbose=False)


@pytest.fixture(scope="module")
def jax_sw():
    """The JAX ``sliding_window_gdg`` with ``last_win_osd`` on the [[72]]
    smoke experiment (its GDG counts are those without), with the GDG
    corrections of its timed decode, read from its window pipeline's
    result (the driver returns only the OSD-redone ones)."""
    seen, pipeline = [], jcl.decode_sliding_window

    def keep_total(*a, **k):
        out = pipeline(*a, **k)
        seen.append(np.asarray(out["total_e_hat"]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "decode_sliding_window", keep_total)
        res = jcl.sliding_window_gdg(ensemble_mode="host_loop", last_win_osd=True, **SW)
    _, _, dem, plan = jcl.build_bb_window_experiment(72, 0.01, 3, 2, 1)
    det, _, _ = sample_dem_numpy(dem, SW["num_shots"], np.random.default_rng(SW["seed"]))
    return res, seen[-1], plan, det


@pytest.mark.parametrize("last_win_osd", [False, True])
def test_sliding_window_gdg_matches_jax(jax_sw, last_win_osd):
    """[[72]] x3 rounds, W=2, p=0.01, 128 shots from seed 2024, pre-BP 8:
    the GDG corrections, failures and flags equal JAX's; with
    ``last_win_osd`` the BPOSD re-decode of the last window too, where a
    shot may differ only at an exact OSD-CS tie (ROADMAP section 3)."""
    rj, total_j, plan, det = jax_sw
    # 32-shot ensemble buckets (JAX: its default 64): the results do not
    # depend on the bucket, and the CPU decode takes half the time
    with _torch_threads(2):
        rt = tcl.sliding_window_gdg(device="cpu", last_win_osd=last_win_osd,
                                    ensemble_bucket=32, **SW)
    np.testing.assert_array_equal(rt["total_e_hat"].numpy(), total_j)
    for k in ("num_failed", "num_flagged", "num_windows", "ler"):
        assert rt[k] == rj[k], k
    assert rt["num_failed"] > 0
    if not last_win_osd:
        assert "last_win_osd" not in rt
        return
    assert rt["last_win_osd"] == rj["last_win_osd"]
    spec = plan.windows[-1]
    tt, tj = rt["total_e_hat_osd"].numpy(), np.asarray(rj["total_e_hat_osd"])
    np.testing.assert_array_equal(tt[:, :spec.col_start], tj[:, :spec.col_start])
    cols = slice(spec.col_start, spec.col_end)
    prefix = total_j.copy()
    prefix[:, spec.col_start:] = 0
    synd = (det ^ (prefix.astype(np.int64) @ plan.chk.T % 2))[:, spec.row_start:spec.row_end]
    llr = np.log((1 - spec.prior) / spec.prior)
    differ = np.nonzero((tt != tj).any(axis=1))[0]
    assert len(differ) <= 2
    for i in differ:
        for e in (tt[i, cols], tj[i, cols]):
            np.testing.assert_array_equal((e.astype(np.int64) @ spec.mat.T) % 2, synd[i])
        assert _weight(llr, tt[i, cols]) == pytest.approx(_weight(llr, tj[i, cols]), rel=1e-12)
