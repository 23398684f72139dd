"""The port's BP (``ops.bp`` / ``ops.bp_cuda``) against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. The JAX side
runs as its own tests run it: XLA on the CPU, and the Pallas CN kernel in
interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.ops import bp as tbp
from slidingwindowdecoder_torch.ops.bp_cuda import cn_update
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays, vn_incidence_host
from slidingwindowdecoder_tpu.ops import bp as jbp
from slidingwindowdecoder_tpu.ops.bp_pallas import cn_update_pallas

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _random_graph(rng, m=24, n=60, dens=0.12):
    """Random PCM with no empty row or column and low degrees (as a DEM
    window has: dv 6 at the flagship), so that XLA sums the few incoming
    messages of a VN in slot order, as the port does."""
    H = (rng.random((m, n)) < dens).astype(np.uint8)
    H[rng.integers(0, m, n), np.arange(n)] = 1
    H[np.arange(m), rng.integers(0, n, m)] = 1
    return H


def _window_pcm():
    """The first [[144]] W=3 window PCM (216x1656: dc 35, m_pad 224)."""
    from slidingwindowdecoder_torch.harness.circuit_level import (
        build_bb_window_experiment,
    )

    _, _, _, plan = build_bb_window_experiment(144, 0.004, 12, 3, 1)
    return plan.windows[0].mat


def _cn_inputs(rng, g, B):
    mv = (rng.standard_normal((g.dc, g.m_pad, B)) * 30).astype(np.float32)
    mv[1, ::3, :] = -mv[0, ::3, :]  # ties of |x| between slots 0 and 1
    mv[2, ::5, :] = mv[3, ::5, :]
    mv[4, ::7, :] = 0.0  # zero counts as negative
    parity = rng.integers(0, 2, (g.m_pad, B)).astype(np.int32)
    return mv, parity


def _as_f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("shape", ["random", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cn_plain_matches_jax_and_pallas(rng, shape, dtype):
    H = _random_graph(rng) if shape == "random" else _window_pcm()
    g = compile_graph(H)
    B = 128
    mv, parity = _cn_inputs(rng, g, B)
    tdt, jdt = DTYPES[dtype]
    alpha = 0.625 if shape == "random" else 1.0

    before = cn_update.plain_calls
    out = cn_update(torch.from_numpy(mv).to(tdt), torch.from_numpy(g.cn_valid_sm),
                    torch.from_numpy(parity), alpha=alpha, clip=50.0)
    assert cn_update.plain_calls == before + 1  # a CPU tensor runs the plain version

    jmv = jnp.asarray(mv).astype(jdt)
    valid = jnp.asarray(g.cn_valid_sm)
    ref = jbp._cn_update_sm(jmv, valid[:, :, None], jnp.asarray(parity),
                            alpha=alpha, clip=50.0)
    pal = cn_update_pallas(jmv, valid, jnp.asarray(parity), alpha=alpha,
                           clip=50.0, interpret=True)
    np.testing.assert_array_equal(_as_f32(out), _as_f32(ref))
    np.testing.assert_array_equal(_as_f32(out), _as_f32(pal))


def _bp_inputs(rng, H, B, p=0.08):
    n = H.shape[1]
    prior = np.log((1 - 0.05) / 0.05) * np.ones(n, np.float32)
    prior[::7] *= 0.5  # non-uniform priors
    errs = (rng.random((B, n)) < p).astype(np.uint8)
    synds = ((errs @ H.T) % 2).astype(np.uint8)
    return prior, synds


def _run_both(H, prior, synds, num_iter, msg_dtype, **kw):
    g = compile_graph(H)
    B, n = synds.shape[0], H.shape[1]
    garr_t = graph_tensors(g, "cpu")
    garr_j = graph_device_arrays(g)
    if kw.get("posterior_matmul"):
        garr_t["vn_inc"] = torch.from_numpy(vn_incidence_host(g))
        garr_j = dict(garr_j, vn_inc=jnp.asarray(vn_incidence_host(g), jnp.bfloat16))

    st = torch.from_numpy(synds)
    mv = tbp.bp_init_messages(garr_t, prior, B)
    out_t = tbp.bp_run(garr_t, mv, prior, st, *tbp.fresh_bp_state(garr_t, B),
                       num_iter=num_iter, alpha=1.0, clip=50.0,
                       msg_dtype=msg_dtype, **kw)

    sj = jnp.asarray(synds)
    mvj = jbp.bp_init_messages(garr_j, prior, B)
    out_j = jbp.bp_run(garr_j, mvj, prior, sj, jnp.full((B, n), -1, jnp.int8),
                       sj.astype(jnp.int8), *jbp.fresh_bp_state(garr_j, B),
                       num_iter=num_iter, alpha=1.0, clip=50.0,
                       msg_dtype=msg_dtype, masked=False, **kw)
    return [np.asarray(x) for x in out_t], [np.asarray(x) for x in out_j]


@pytest.mark.parametrize("history_mode", ["none", "tail", "full"])
@pytest.mark.parametrize("freeze", [True, False])
def test_bp_run_f32_bit_equal(rng, history_mode, freeze):
    H = _random_graph(rng)
    prior, synds = _bp_inputs(rng, H, 128)
    (mv_t, hist_t, err_t, done_t, it_t), (mv_j, hist_j, err_j, done_j, it_j) = _run_both(
        H, prior, synds, 14, "float32", freeze_messages=freeze,
        history_mode=history_mode,
    )
    assert 0 < done_j.sum() < len(done_j)  # some shots converge, some do not
    np.testing.assert_array_equal(err_t, err_j)
    np.testing.assert_array_equal(done_t, done_j)
    np.testing.assert_array_equal(it_t, it_j)
    np.testing.assert_array_equal(hist_t, hist_j)
    if freeze:  # unfrozen converged rows may run extra iterations here
        np.testing.assert_array_equal(mv_t, mv_j)
    else:
        np.testing.assert_array_equal(mv_t[~done_j], mv_j[~done_j])


def test_bp_run_bf16_decisions_equal(rng):
    """bf16 messages, JAX with its BPOSD choice ``posterior_matmul=True``.

    Decisions, convergence and iteration counts must be equal. Messages and
    history agree to bf16 rounding only (rtol 2**-7, one bf16 ulp; atol
    1e-2 for values near 0): XLA on the CPU may keep bf16 elementwise
    intermediates in f32 (excess precision), and its bf16 incidence matmul
    sums in another order than the port's slot-by-slot f32 gather-sum.
    """
    H = _window_pcm()
    prior, synds = _bp_inputs(rng, H, 64, p=0.004)
    (mv_t, hist_t, err_t, done_t, it_t), (mv_j, hist_j, err_j, done_j, it_j) = _run_both(
        H, prior, synds, 12, "bfloat16", freeze_messages=True,
        history_mode="full", posterior_matmul=True,
    )
    assert 0 < done_j.sum() < len(done_j)
    np.testing.assert_array_equal(err_t, err_j)
    np.testing.assert_array_equal(done_t, done_j)
    np.testing.assert_array_equal(it_t, it_j)
    np.testing.assert_allclose(hist_t, hist_j, rtol=2**-7, atol=1e-2)
    np.testing.assert_allclose(mv_t, mv_j, rtol=2**-7, atol=1e-2)


def test_decode_bp_matches_jax(rng):
    H = _random_graph(rng)
    prior, synds = _bp_inputs(rng, H, 64)
    g = compile_graph(H)
    out_t = tbp.decode_bp(graph_tensors(g, "cpu"), prior, torch.from_numpy(synds),
                          num_iter=10)
    out_j = jbp.decode_bp(graph_device_arrays(g), prior, jnp.asarray(synds),
                          num_iter=10)
    for k in ("error", "converged", "iterations", "history", "llr_sum", "mv"):
        np.testing.assert_array_equal(np.asarray(out_t[k]), np.asarray(out_j[k]), err_msg=k)


def test_bp_run_slot_major_matches_batch_major(rng):
    """The slot-major carry BPOSD uses gives the batch-major results."""
    H = _random_graph(rng)
    prior, synds = _bp_inputs(rng, H, 32)
    g = compile_graph(H)
    garr = graph_tensors(g, "cpu")
    B = synds.shape[0]
    st = torch.from_numpy(synds)
    kw = dict(num_iter=9, msg_dtype="bfloat16", history_mode="full")
    bm = tbp.bp_run(garr, tbp.bp_init_messages(garr, prior, B), prior, st,
                    *tbp.fresh_bp_state(garr, B), **kw)
    hist, err, done, iters = tbp.fresh_bp_state(garr, B)
    sm = tbp.bp_run(garr, tbp.bp_init_messages_sm(garr, prior, B, "bfloat16"), prior,
                    st, hist.permute(1, 2, 0), err, done, iters,
                    io_layout="slot_major", **kw)
    torch.testing.assert_close(sm[0][:, : g.m].permute(2, 1, 0).float(), bm[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(sm[1].permute(2, 0, 1), bm[1], rtol=0, atol=0)
    for a, b in zip(sm[2:], bm[2:]):
        assert torch.equal(a, b)
