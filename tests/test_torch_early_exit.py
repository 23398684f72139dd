"""``bp_run(early_exit=False)`` and ``GDG(ensemble_early_exit=...)`` of the
port against ``early_exit=True`` and against the JAX package (f32, CPU):
the fixed-trip form gives bit-identical results."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.codes import bb_code_by_n
from slidingwindowdecoder_torch.decoders import GDG
from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.ops import bp as tbp
from slidingwindowdecoder_tpu.decoders import GDG as JGDG
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays
from slidingwindowdecoder_tpu.ops import bp as jbp


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _inputs(seed, m=24, n=60, B=128, p=0.05):
    """A random PCM with low degrees (no empty row or column), non-uniform
    priors and code-capacity syndromes, as in ``test_torch_bp.py``."""
    rng = np.random.default_rng(seed)
    H = (rng.random((m, n)) < 0.12).astype(np.uint8)
    H[rng.integers(0, m, n), np.arange(n)] = 1
    H[np.arange(m), rng.integers(0, n, m)] = 1
    prior = np.log((1 - p) / p) * np.ones(n, np.float32)
    prior[::7] *= 0.5
    errs = (rng.random((B, n)) < p).astype(np.uint8)
    return H, prior, ((errs @ H.T) % 2).astype(np.uint8)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("history_mode", ["full", "tail"])
def test_bp_run_fixed_trips_bit_identical(masked, history_mode):
    H, prior, synds = _inputs(3)
    g = compile_graph(H)
    B, n = synds.shape[0], H.shape[1]
    garr_t, garr_j = graph_tensors(g, "cpu"), graph_device_arrays(g)
    vn = np.full((B, n), -1, np.int8)
    if masked:  # a few VNs decided per shot
        rng = np.random.default_rng(4)
        pick = rng.random((B, n)) < 0.1
        vn[pick] = 0
    kw = dict(num_iter=14, alpha=1.0, clip=50.0, msg_dtype="float32", history_mode=history_mode)

    def port(early_exit):
        st = torch.from_numpy(synds)
        return [x.numpy() for x in tbp.bp_run(
            garr_t, tbp.bp_init_messages(garr_t, prior, B), prior, st,
            *tbp.fresh_bp_state(garr_t, B), masked=masked,
            vn_state=torch.from_numpy(vn) if masked else None, early_exit=early_exit, **kw)]

    sj = jnp.asarray(synds)
    out_j = [np.asarray(x) for x in jbp.bp_run(
        garr_j, jbp.bp_init_messages(garr_j, prior, B), prior, sj, jnp.asarray(vn),
        sj.astype(jnp.int8), *jbp.fresh_bp_state(garr_j, B), masked=masked, early_exit=False,
        **kw)]
    fixed, early = port(False), port(True)
    assert 0 < fixed[3].sum() < B  # some shots converge, some do not
    for a, b, c in zip(fixed, early, out_j):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_fixed_trips_skip_the_all_done_read():
    """With every shot done after its first iteration, the plain loop stops
    at its next all-done read with ``early_exit``, and runs every trip
    without it (the CN stage's plain calls count the trips; the outputs
    equal)."""
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update

    H, prior, synds = _inputs(5, B=32)
    synds[:] = 0  # every shot converges at its first iteration
    garr = graph_tensors(compile_graph(H), "cpu")
    B = synds.shape[0]
    outs, trips = {}, {}
    for early in (True, False):
        before = cn_update.plain_calls
        outs[early] = [x.numpy() for x in tbp.bp_run(
            garr, tbp.bp_init_messages(garr, prior, B), prior, torch.from_numpy(synds),
            *tbp.fresh_bp_state(garr, B), num_iter=12, early_exit=early)]
        trips[early] = cn_update.plain_calls - before
    assert trips == {True: tbp.EXIT_CHECK_EVERY, False: 12}
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


def test_gdg_ensemble_early_exit_results_unchanged():
    """[[72]] hx at p=0.13, 32 jittered-prior shots, the knobs of
    ``test_torch_gdg.py``: the port's GDG (fused ensemble) with either flag
    equals the JAX GDG with ``ensemble_early_exit=False`` (host-stepped
    ensemble); every shot converges here, so the fixed trips move no
    output."""
    code, _, _ = bb_code_by_n(72)
    rng = np.random.default_rng(7)
    p = 0.13
    probs = p * (0.75 + 0.5 * rng.random(code.N))
    errs = (rng.random((32, code.N)) < probs).astype(np.uint8)
    synds = ((errs @ code.hx.T) % 2).astype(np.uint8)
    kw = dict(max_iter=24, ms_scaling_factor=1.0, gdg_factor=1.0, max_iter_per_step=6,
              max_step=40, max_tree_depth=3, max_side_depth=10, max_tree_branch_step=20,
              max_side_branch_step=20, ensemble_bucket=16)
    rj = JGDG(code.hx, probs, ensemble_mode="host_loop", ensemble_early_exit=False,
              **kw).decode_batch(synds)
    for flag in (False, True):
        dec = GDG(code.hx, probs, ensemble_early_exit=flag, device="cpu", **kw)
        assert dec.ensemble_early_exit is flag
        rt = dec.decode_batch(synds)
        np.testing.assert_array_equal(rt.error, rj.error)
        np.testing.assert_array_equal(rt.converged, rj.converged)
        np.testing.assert_array_equal(rt.iterations, rj.iterations)
