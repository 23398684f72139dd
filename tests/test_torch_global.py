"""The port's whole-block decode (``harness.circuit_level.global_decoder``)
against the JAX package, and the routing of kernel B's cluster route.

The decode runs at a small size on the CPU: the [[72,12,6]] BB code, 3
rounds, p=0.01 (a 144x1152 DEM), 128 shots from seed 2024, in both forms
(BP+OSD-CS-10 with the flagship knobs and bf16 messages, and the shortened
``OSDWindow``). The counts must be equal; per shot, the corrections must be
equal except at an exact OSD-CS tie (ROADMAP section 3): both corrections
satisfy the syndrome and have equal f64 weight.

The cluster route's kernel itself runs only on the card
(``tests/test_torch_cuda.py``); here its gate and per-block layouts are
held at the shapes the slice gives it.
"""

import contextlib

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.circuits import sample_dem_numpy
from slidingwindowdecoder_torch.harness import circuit_level as tcl
from slidingwindowdecoder_torch.ops import gf2_cuda
from slidingwindowdecoder_tpu.decoders import BPOSD as JBPOSD
from slidingwindowdecoder_tpu.decoders import OSDWindow as JOSDWindow
from slidingwindowdecoder_tpu.harness import circuit_level as jcl

N, P, ROUNDS, SHOTS, SEED = 72, 0.01, 3, 128, 2024


@contextlib.contextmanager
def _torch_threads(k):
    """At most ``k`` torch intra-op threads inside the block: where the test
    workers share the cores, a decode of many small ops on every core's
    thread slows tens of times (a 7 s decode here took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(k, n))
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("shorten", [False, True], ids=["bposd", "shortened"])
def test_global_decoder_matches_jax(shorten):
    with _torch_threads(2):
        rt = tcl.global_decoder(N, P, ROUNDS, SHOTS, seed=SEED, shorten=shorten, device="cpu",
                                verbose=False)
    rj = jcl.global_decoder(N, P, ROUNDS, SHOTS, seed=SEED, shorten=shorten, verbose=False)
    assert rt["num_failed"] > 0
    assert (rt["num_failed"], rt["num_flagged"]) == (rj["num_failed"], rj["num_flagged"])
    assert set(rt) == set(rj)


def test_global_decoder_needs_a_card_by_default(monkeypatch):
    """As every entry point: ``device=None`` means the card, and without one
    it raises rather than decode on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcl.global_decoder(N, P, ROUNDS, 8, seed=SEED, verbose=False)


def _jax_decoder(dem, shorten):
    """The JAX decoder as ``global_decoder`` builds it
    (``harness/circuit_level.py:199-213``)."""
    if shorten:
        return JOSDWindow(dem.chk, dem.priors, pre_max_iter=8, post_max_iter=200,
                          ms_scaling_factor=1.0, osd_method="osd_cs", osd_order=10)
    return JBPOSD(dem.chk, dem.priors, max_iter=200, ms_scaling_factor=1.0,
                  osd_method="osd_cs", osd_order=10, msg_dtype="bfloat16",
                  phase_a_iters=16, bp_bucket=1024, osd_bucket=256)


@pytest.mark.parametrize("shorten", [False, True], ids=["bposd", "shortened"])
def test_global_decoders_match_jax_per_shot(shorten):
    """``build_global_decoder``'s decoder and the JAX one on the same
    detector samples: convergence equal on every shot, corrections equal
    but at exact OSD-CS ties."""
    dem = tcl.build_bb_window_experiment(N, P, ROUNDS, 2, 1)[2]
    det, _, _ = sample_dem_numpy(dem, SHOTS, np.random.default_rng(SEED))
    with _torch_threads(2):
        out_t = tcl.build_global_decoder(dem, shorten, device="cpu").core(torch.as_tensor(det))
    out_j = _jax_decoder(dem, shorten).decode_batch_device(det)
    e_t, e_j = out_t["error"].numpy(), np.asarray(out_j["error"])
    np.testing.assert_array_equal(out_t["converged"].numpy(), np.asarray(out_j["converged"]))
    np.testing.assert_array_equal(out_t["osd_applied"].numpy(),
                                  np.asarray(out_j["osd_applied"]))
    assert out_t["osd_applied"].any()
    llr = np.log((1 - dem.priors) / dem.priors).astype(np.float32).astype(np.float64)
    for b in np.nonzero((e_t != e_j).any(axis=1))[0]:
        for e in (e_t, e_j):
            np.testing.assert_array_equal((dem.chk @ e[b]) % 2, det[b], err_msg=f"shot {b}")
        assert llr @ e_t[b] == llr @ e_j[b], b


# (m, n, blocks per shot of the elimination alone, of the fused launch)
CLUSTER_SHAPES = [(576, 4752, 2, 2), (576, 4896, 2, 2), (936, 8784, 8, 8)]


@pytest.mark.parametrize("m, n, c_gj, c_fused", CLUSTER_SHAPES)
def test_cluster_route_gate(m, n, c_gj, c_fused):
    """The interior and edge [[288]] W=4 windows and the [[144]] global DEM
    fit no single block; the route takes the least cluster whose blocks
    each hold their rows within the shared memory of a block, and a
    smaller cluster would not fit."""
    W = -(-n // 32)
    for fused, C in ((False, c_gj), (True, c_fused)):
        assert not gf2_cuda.gj_cuda_supported(m, n, W, fused)
        assert gf2_cuda.gj_cluster_supported(m, n, W, fused) == C
        assert gf2_cuda.gj_route(m, n, W, fused) == C
        layout = gf2_cuda.cluster_smem_layout(m, n, W, C, fused)
        assert gf2_cuda.cluster_smem_bytes(m, n, W, C, fused) <= gf2_cuda.MAX_SMEM
        assert layout["state"] >= gf2_cuda.cluster_rows(m, C) * (W + 1) * 4
        assert gf2_cuda.cluster_rows(m, C) * C >= m
        for smaller in gf2_cuda.CLUSTER_SIZES[:gf2_cuda.CLUSTER_SIZES.index(C)]:
            assert gf2_cuda.cluster_smem_bytes(m, n, W, smaller, fused) > gf2_cuda.MAX_SMEM


def test_cluster_route_layouts():
    """At 936x8784 (C=8, 117 rows a block) the sort's pairs outgrow a
    block's rows of the state; the fused launch adds the running column
    and pair sums, its rows' weights and four column masks."""
    m, n, W = 936, 8784, 275
    plain = gf2_cuda.cluster_smem_layout(m, n, W, 8)
    fused = gf2_cuda.cluster_smem_layout(m, n, W, 8, True)
    assert plain["state"] == 16384 * 8 > 117 * 276 * 4
    assert fused == {**plain, "column_sums": 4 * n, "pair_sums": 4 * 496,
                     "row_weights": 4 * 117, "column_masks": 16 * W}
    assert gf2_cuda.cluster_smem_bytes(m, n, W, 8, True) == 196_432
    assert gf2_cuda.cluster_smem_bytes(576, 4896, 153, 2, True) == 219_024


def test_route_keeps_single_block_shapes_and_raises_beyond():
    """The shapes of the earlier paths keep the single-block route; a
    forced cluster must fit; a shape no cluster of 8 holds raises."""
    for m, n in ((216, 1728), (216, 1656), (441, 882), (72, 468)):
        W = -(-n // 32)
        for fused in (False, True):
            assert gf2_cuda.gj_route(m, n, W, fused) == 0
            assert gf2_cuda.gj_route(m, n, W, fused, 4) == 4
    with pytest.raises(ValueError, match="does not fit clusters of 3"):
        gf2_cuda.gj_route(216, 1728, 54, True, 3)
    for m, n in ((5000, 8784), (936, 40000)):  # rows a block, or shared memory
        W = -(-n // 32)
        assert gf2_cuda.gj_cluster_supported(m, n, W, True) == 0
        with pytest.raises(ValueError, match="outside both routes"):
            gf2_cuda.gj_route(m, n, W, True)


def test_cpu_tensors_take_the_plain_version_on_either_route():
    """On CPU tensors a forced cluster route still runs the plain version
    (the route is a choice of kernel, not of function)."""
    rng = np.random.default_rng(3)
    H = (rng.random((24, 300)) < 0.1).astype(np.uint8)
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        gf2_rank_packed,
        ordered_gauss_jordan_key,
        pack_rows_host,
    )

    m, n = H.shape
    Hw = torch.as_tensor(pack_rows_host(H).view(np.int32))
    synd = torch.as_tensor(rng.integers(0, 2, (5, m)), dtype=torch.uint8)
    key = torch.as_tensor(rng.integers(0, 8, (5, n)), dtype=torch.float32)
    kw = dict(m=m, n=n, rank=gf2_rank_packed(H))
    before = (gf2_cuda.gauss_jordan_key.plain_calls,
              gf2_cuda.gauss_jordan_key.cluster_launches)
    out = gf2_cuda.gauss_jordan_key(Hw, synd, key, **kw, cluster_blocks=2)
    assert (gf2_cuda.gauss_jordan_key.plain_calls,
            gf2_cuda.gauss_jordan_key.cluster_launches) == (before[0] + 1, before[1])
    ref = ordered_gauss_jordan_key(Hw, synd, key, **kw)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
