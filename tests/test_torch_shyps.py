"""The SHYPS driver of the port against the JAX package, on the CPU.

``utils.matching`` and ``circuits.shyps`` are numpy copies: the same code,
edge colouring, circuit and DEM (105x833 at r = 3 over 4 rounds). The
port's ``decode_shyps`` is held to the JAX package's decode of the same
detector samples, per shot: its global form against the JAX ``BPOSD`` on
the whole DEM, its window form against the JAX ``decode_sliding_window``
with the same (W, F) = (3, 1) method-0 plan, both at the parity rows'
decoder (``osd_method="osd_cs"`` with ``osd_order=0``: OSD-CS over the k
weight-1 candidates) with 60 BP iterations, on 256 shots. BP, the
elimination and the CS sweep agree on every shot here, so the corrections
are held equal with no tie allowance, and so are the failure counts.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.circuits import compile_dem
from slidingwindowdecoder_torch.circuits import shyps as tshyps
from slidingwindowdecoder_torch.harness.shyps import decode_shyps
from slidingwindowdecoder_torch.utils import matching as tmatching
from slidingwindowdecoder_tpu.circuits import compile_dem as jax_compile_dem
from slidingwindowdecoder_tpu.circuits import shyps as jshyps
from slidingwindowdecoder_tpu.circuits.sampler import sample_dem_numpy
from slidingwindowdecoder_tpu.decoders import BPOSD as JaxBPOSD
from slidingwindowdecoder_tpu.utils import matching as jmatching
from slidingwindowdecoder_tpu.windows.pipeline import (
    CachingDecoderFactory,
    decode_sliding_window,
)
from slidingwindowdecoder_tpu.windows.regions import build_sliding_window_plan

R, P, ROUNDS, SHOTS, ITERS, SEED = 3, 0.001, 4, 256, 60, 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: these decodes are many small ops, and where
    the test workers share the cores more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _jax_dem():
    return jax_compile_dem(jshyps.build_shyps_circuit(R, P, ROUNDS)[0])


def test_shyps_code_circuit_and_dem_match_jax():
    tc, jc = tshyps.build_shyps_code(R), jshyps.build_shyps_code(R)
    for f in ("S_X", "S_Z", "gauge_X", "gauge_Z", "aggregate_X", "aggregate_Z", "L_X", "L_Z"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f)
    assert tmatching.edge_coloring_bipartite(tc.gauge_X) == \
        jmatching.edge_coloring_bipartite(jc.gauge_X)
    adj = {0: [1, 2], 1: [0], 2: [0, 2]}
    assert tmatching.hopcroft_karp(adj, [0, 1, 2], [0, 1, 2]) == \
        jmatching.hopcroft_karp(adj, [0, 1, 2], [0, 1, 2])
    circuit, _ = tshyps.build_shyps_circuit(R, P, ROUNDS)
    assert circuit.num_detectors == R * (2**R - 1) * (ROUNDS + 1)
    dem_t, dem_j = compile_dem(circuit), _jax_dem()
    assert dem_t.chk.shape == (105, 833)
    for f in ("chk", "obs", "priors"):
        np.testing.assert_array_equal(getattr(dem_t, f), getattr(dem_j, f), err_msg=f)


def _jax_e_hat(window: bool):
    """(check matrix, observables matrix, detectors, observables, the JAX
    package's corrections) of ``decode_shyps``'s samples, by the calls its
    ``decode_shyps`` makes; the window form's columns are its plan's."""
    dem = _jax_dem()
    det, obs, _ = sample_dem_numpy(dem, SHOTS, np.random.default_rng(SEED))
    build = functools.partial(JaxBPOSD, max_iter=ITERS, ms_scaling_factor=1.0,
                              osd_method="osd_cs", osd_order=0)
    if not window:
        return dem.chk, dem.obs, det, obs, np.asarray(
            build(dem.chk, dem.priors).decode_batch_device(jnp.asarray(det))["error"])
    plan = build_sliding_window_plan(dem.chk, dem.obs, dem.priors, n_half=R * (2**R - 1),
                                     W=3, F=1, method=0)
    factory = CachingDecoderFactory(lambda spec: build(spec.mat, spec.prior))
    return plan.chk, plan.obs, det, obs, np.asarray(
        decode_sliding_window(plan, det, factory, verbose=False)["total_e_hat"])


@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
def test_decode_shyps_matches_jax_per_shot(window):
    res = decode_shyps(r=R, p=P, num_repeat=ROUNDS, num_shots=SHOTS, max_iter=ITERS,
                       osd_order=0, window=window, seed=SEED, verbose=False, device="cpu")
    chk, obs_mat, det, obs, e_j = _jax_e_hat(window)
    np.testing.assert_array_equal(res["e_hat"], e_j)
    resid = ((e_j.astype(np.int64) @ chk.T) % 2 != det).any(axis=1)
    logical = ((e_j.astype(np.int64) @ obs_mat.T) % 2 != obs).any(axis=1)
    assert res["num_failed"] == int((resid | logical).sum())
    assert res["num_flagged"] == int(resid.sum())
    assert res["num_shots"] == SHOTS and res["window"] == window


@pytest.mark.slow
@pytest.mark.parametrize("window", [False, True], ids=["global", "window"])
def test_shyps_rows_seed7_match_jax_on_the_cpu(window):
    """The shyps-window and shyps-global rows at their full knobs (16384
    shots, seed 7, 1000 iterations) on the CPU: the port counts what the
    JAX package counts on the CPU (131 in both forms, where the JAX
    package's TPU runs counted 128 and 126; ~5 min a side and form)."""
    from slidingwindowdecoder_tpu.harness.shyps import decode_shyps as jax_decode_shyps

    kw = dict(r=R, p=P, num_repeat=ROUNDS, num_shots=16384, max_iter=1000, osd_order=0,
              window=window, W=3, F=1, seed=7, verbose=False)
    res = decode_shyps(device="cpu", **kw)
    res_j = jax_decode_shyps(**kw)
    assert (res["num_failed"], res["num_flagged"]) == (res_j["num_failed"],
                                                       res_j["num_flagged"])
