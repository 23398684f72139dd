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
from slidingwindowdecoder_torch.ops import decimation as tdec
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


def _pinned_cn_inputs(rng, g, B, dtype):
    """CN inputs of the masked mode: ~30 % of the edges pinned at the
    dtype-rounded PIN, whole rows pinned, ties, zeros and values beyond
    +-clip."""
    mv, parity = _cn_inputs(rng, g, B)
    mv[5 % g.dc, ::11, :] = 80.0  # beyond +clip
    mv[6 % g.dc, ::13, :] = -75.0  # beyond -clip
    pin = float(torch.tensor(tbp.PIN, dtype=dtype).float())
    mv[rng.random(mv.shape) < 0.3] = pin
    mv[:, ::9, :] = pin  # every edge of these checks pinned
    return mv, parity


@pytest.mark.parametrize("shape", ["random", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cn_pinned_plain_matches_jax_and_pallas(rng, shape, dtype):
    """The plain pinned CN update equals the JAX ``_cn_update_sm(pinned=True)``
    and the Pallas kernel in interpret mode, bit for bit."""
    H = _random_graph(rng) if shape == "random" else _window_pcm()
    g = compile_graph(H)
    B = 128
    tdt, jdt = DTYPES[dtype]
    mv, parity = _pinned_cn_inputs(rng, g, B, tdt)
    alpha = 0.625 if shape == "random" else 1.0

    before = cn_update.plain_calls
    out = cn_update(torch.from_numpy(mv).to(tdt), torch.from_numpy(g.cn_valid_sm),
                    torch.from_numpy(parity), alpha=alpha, clip=50.0, pinned=True)
    assert cn_update.plain_calls == before + 1

    jmv = jnp.asarray(mv).astype(jdt)
    valid = jnp.asarray(g.cn_valid_sm)
    ref = jbp._cn_update_sm(jmv, valid[:, :, None], jnp.asarray(parity),
                            alpha=alpha, clip=50.0, pinned=True)
    pal = cn_update_pallas(jmv, valid, jnp.asarray(parity), alpha=alpha,
                           clip=50.0, interpret=True, pinned=True)
    np.testing.assert_array_equal(_as_f32(out), _as_f32(ref))
    np.testing.assert_array_equal(_as_f32(out), _as_f32(pal))
    if alpha == 1.0:  # a check whose every valid edge is pinned emits BIG
        big = float(torch.tensor(tbp.BIG, dtype=tdt).float())
        row = _as_f32(out)[:, 0, :][g.cn_valid_sm[:, 0]]
        assert row.size and (np.abs(row) == big).all()


def _low_degree_graph(rng):
    """A random graph whose VN degrees are at most 6, as in a DEM window:
    XLA's CPU reduce may sum the messages of a degree-8 VN in interleaved
    partial sums, one f32 ulp away from the port's slot order (ROADMAP
    section 3), and in masked mode such a ulp can flip a near-zero message."""
    H = _random_graph(rng)
    for j in range(H.shape[1]):
        rows = np.nonzero(H[:, j])[0]
        H[rows[6:], j] = 0
    for i in np.nonzero(H.sum(axis=1) == 0)[0]:
        H[i, rng.choice(np.nonzero(H.sum(axis=0) < 6)[0])] = 1
    assert H.sum(axis=0).max() <= 6 and H.sum(axis=1).min() >= 1
    return H


def _masked_inputs(rng, H, B):
    """Prior, syndromes and a decimation state: about a third of the VNs
    decided to their true value, one wrong decision in a fifth of the
    rows, and ~10 % of the rows dead."""
    g = compile_graph(H)
    n = H.shape[1]
    p = 0.04 if n < 200 else 0.004
    prior = np.log((1 - p) / p) * np.ones(n, np.float32)
    prior[::7] *= 0.5
    errs = (rng.random((B, n)) < p).astype(np.int8)
    synds = ((errs @ H.T) % 2).astype(np.uint8)
    set_mask = rng.random((B, n)) < 1 / 3
    values = errs.copy()
    wrong = np.nonzero(rng.random(B) < 0.2)[0]
    values[wrong, rng.integers(0, n, wrong.size)] ^= 1
    set_mask[wrong] |= values[wrong] != errs[wrong]
    garr = graph_tensors(g, "cpu")
    state = tdec.init_decimation_state(garr, torch.from_numpy(synds))
    state = tdec.vn_set_values(garr, *state, torch.from_numpy(set_mask),
                               torch.from_numpy(values))
    vn, cn, _, dead = (x.numpy() for x in tdec.peel(garr, *state))
    dead = dead | (rng.random(B) < 0.1)
    return g, prior, synds, vn, cn, dead


def _run_both_masked(g, prior, synds, vn, cn, dead, num_iter, msg_dtype, alpha, **kw):
    B = synds.shape[0]
    garr_t, garr_j = graph_tensors(g, "cpu"), graph_device_arrays(g)
    err0 = np.where(vn != -1, vn, 0).astype(np.int8)
    hist_t, _, _, it_t = tbp.fresh_bp_state(garr_t, B)
    out_t = tbp.bp_run(
        garr_t, tbp.bp_init_messages(garr_t, prior, B), prior, torch.from_numpy(synds),
        hist_t, torch.from_numpy(err0), torch.from_numpy(dead), it_t,
        num_iter=num_iter, alpha=alpha, clip=50.0, msg_dtype=msg_dtype,
        vn_state=torch.from_numpy(vn), cn_state=torch.from_numpy(cn), masked=True, **kw)
    hist_j, _, _, it_j = jbp.fresh_bp_state(garr_j, B)
    out_j = jbp.bp_run(
        garr_j, jbp.bp_init_messages(garr_j, prior, B), prior, jnp.asarray(synds),
        jnp.asarray(vn), jnp.asarray(cn), hist_j, jnp.asarray(err0), jnp.asarray(dead),
        it_j, num_iter=num_iter, alpha=alpha, clip=50.0, msg_dtype=msg_dtype,
        masked=True, **kw)
    return [np.asarray(x) for x in out_t], [np.asarray(x) for x in out_j]


@pytest.mark.parametrize("shape", ["random", "window"])
@pytest.mark.parametrize("history_mode", ["none", "tail", "full"])
@pytest.mark.parametrize("freeze", [True, False])
def test_bp_run_masked_f32_bit_equal(rng, shape, history_mode, freeze):
    """Masked ``bp_run`` (f32, alpha 1.0) against the JAX masked ``bp_run``
    at B=128: every output bit-equal, pinned messages included."""
    H = _low_degree_graph(rng) if shape == "random" else _window_pcm()
    g, prior, synds, vn, cn, dead = _masked_inputs(rng, H, 128)
    (mv_t, hist_t, err_t, done_t, it_t), (mv_j, hist_j, err_j, done_j, it_j) = (
        _run_both_masked(g, prior, synds, vn, cn, dead, 14, "float32", 1.0,
                         freeze_messages=freeze, history_mode=history_mode))
    assert 0 < (done_j & ~dead).sum() < (~dead).sum()  # some converge, some not
    np.testing.assert_array_equal(err_t, err_j)
    np.testing.assert_array_equal(done_t, done_j)
    np.testing.assert_array_equal(it_t, it_j)
    np.testing.assert_array_equal(hist_t, hist_j)
    if freeze:
        np.testing.assert_array_equal(mv_t, mv_j)
    else:
        np.testing.assert_array_equal(mv_t[~done_j], mv_j[~done_j])


@pytest.mark.parametrize("shape", ["random", "window"])
@pytest.mark.parametrize("msg_dtype,alpha", [("bfloat16", 1.0), ("float32", 0.625)])
def test_bp_run_masked_decisions_equal(rng, shape, msg_dtype, alpha):
    """Masked ``bp_run`` in bf16, or with alpha 0.625: decisions,
    convergence and iteration counts equal; messages and history within
    rtol 2**-7 (one bf16 ulp) and atol 1e-2. XLA on the CPU may contract
    ``post_edge - alpha*mag`` into an FMA (tests/test_bp_pallas.py:109-115)
    and keep bf16 intermediates in f32."""
    H = _low_degree_graph(rng) if shape == "random" else _window_pcm()
    g, prior, synds, vn, cn, dead = _masked_inputs(rng, H, 128)
    (mv_t, hist_t, err_t, done_t, it_t), (mv_j, hist_j, err_j, done_j, it_j) = (
        _run_both_masked(g, prior, synds, vn, cn, dead, 12, msg_dtype, alpha,
                         history_mode="full"))
    assert 0 < (done_j & ~dead).sum() < (~dead).sum()
    np.testing.assert_array_equal(err_t, err_j)
    np.testing.assert_array_equal(done_t, done_j)
    np.testing.assert_array_equal(it_t, it_j)
    np.testing.assert_allclose(hist_t, hist_j, rtol=2**-7, atol=1e-2)
    np.testing.assert_allclose(mv_t, mv_j, rtol=2**-7, atol=1e-2)


def test_decode_bp_masked_matches_jax(rng):
    """``decode_bp`` with a vn_state runs masked (``masked=None``), as in JAX."""
    H = _low_degree_graph(rng)
    g, prior, synds, vn, cn, _ = _masked_inputs(rng, H, 64)
    out_t = tbp.decode_bp(graph_tensors(g, "cpu"), prior, torch.from_numpy(synds),
                          num_iter=10, vn_state=torch.from_numpy(vn),
                          cn_state=torch.from_numpy(cn))
    out_j = jbp.decode_bp(graph_device_arrays(g), prior, jnp.asarray(synds),
                          num_iter=10, vn_state=jnp.asarray(vn), cn_state=jnp.asarray(cn))
    for k in ("error", "converged", "iterations", "history", "llr_sum", "mv"):
        np.testing.assert_array_equal(np.asarray(out_t[k]), np.asarray(out_j[k]), err_msg=k)


def _transposed_inputs(rng, g, synds, vn, cn, dead, B):
    """The GDG burst's transposed state from batch-major inputs: syndrome
    and CN state [m_pad, B] (pad rows 0 / -1), VN state and error [n, B],
    a history ring of random values (the entries no write reaches must
    keep them), some rows done at entry."""
    m, n, m_pad = g.m, g.n, g.m_pad
    synd_t = np.zeros((m_pad, B), np.int8)
    synd_t[:m] = synds.T
    cn_t = np.full((m_pad, B), -1, np.int8)
    cn_t[:m] = cn.T
    err_t = np.where(vn != -1, vn, 0).astype(np.int8).T.copy()
    hist = rng.standard_normal((n, 4, B)).astype(np.float32)
    done = dead | (rng.random(B) < 0.1)
    return synd_t, cn_t, vn.T.copy(), err_t, hist, done


def _run_both_transposed(g, prior, synds, vn, cn, dead, B, msg_dtype, rng):
    garr_t, garr_j = graph_tensors(g, "cpu"), graph_device_arrays(g)
    synd_t, cn_t, vn_t, err_t, hist, done = _transposed_inputs(rng, g, synds, vn, cn, dead, B)
    kw = dict(num_iter=6, alpha=1.0, clip=50.0, msg_dtype=msg_dtype, return_synd=True,
              io_layout="slot_major", history_mode="tail", hist_update="slice",
              state_layout="transposed")
    it0 = np.zeros(B, np.int32)
    out_t = tbp.bp_run(
        garr_t, tbp.bp_init_messages_sm(garr_t, prior, B, msg_dtype), prior,
        torch.from_numpy(synd_t), torch.from_numpy(hist), torch.from_numpy(err_t),
        torch.from_numpy(done), torch.from_numpy(it0), vn_state=torch.from_numpy(vn_t),
        cn_state=torch.from_numpy(cn_t), masked=True, **kw)
    out_j = jbp.bp_run(
        garr_j, jbp.bp_init_messages_sm(garr_j, prior, B, msg_dtype), prior,
        jnp.asarray(synd_t), jnp.asarray(vn_t), jnp.asarray(cn_t), jnp.asarray(hist),
        jnp.asarray(err_t), jnp.asarray(done), jnp.asarray(it0), masked=True, **kw)
    return ([_as_f32(x) if x.dtype == torch.bfloat16 else x.numpy() for x in out_t],
            [np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x)
             for x in out_j], vn_t, hist)


@pytest.mark.parametrize("shape", ["random", "window"])
def test_bp_run_transposed_synd_slice_f32_matches_jax(rng, shape):
    """The GDG ensemble's burst (masked, transposed state, ``return_synd``,
    ``hist_update="slice"``, 6 iterations with tail history, f32) against
    JAX at B=128: error, done, iterations and ``synd_hat`` bit-equal, the
    messages of the rows not done bit-equal, and the ring equal on the rows
    still active after the burst x their undecided VNs (the entries JAX's
    slice form writes and the port's masked write skips are those no reader
    sees). The port keeps the entry values elsewhere."""
    H = _low_degree_graph(rng) if shape == "random" else _window_pcm()
    g, prior, synds, vn, cn, dead = _masked_inputs(rng, H, 128)
    (mv_t, hist_t, err_t, done_t, it_t, sh_t), (mv_j, hist_j, err_j, done_j, it_j, sh_j), \
        vn_t, hist0 = _run_both_transposed(g, prior, synds, vn, cn, dead, 128, "float32", rng)
    assert 0 < (done_j & ~dead).sum() < (~dead).sum()
    assert err_t.shape == (g.n, 128) and sh_t.shape == (g.m_pad, 128)
    for name, a, b in (("error", err_t, err_j), ("done", done_t, done_j),
                       ("iters", it_t, it_j), ("synd_hat", sh_t, sh_j),
                       ("messages", mv_t[:, :, ~done_j], mv_j[:, :, ~done_j])):
        np.testing.assert_array_equal(a, b, err_msg=name)
    read = (vn_t == -1)[:, None, :] & ~done_j[None, None, :]
    read = np.broadcast_to(read, hist_t.shape)
    np.testing.assert_array_equal(hist_t[read], hist_j[read])
    assert read.any() and (hist_t[~read] == hist0[~read]).mean() > 0.5
    assert not sh_t[g.m:].any()


def test_bp_run_transposed_bf16_decisions_equal(rng):
    """The same burst with bf16 messages on the flagship window graph:
    error, done, iterations and ``synd_hat`` equal (decisions), the ring
    on the rows read within one bf16 ulp."""
    g, prior, synds, vn, cn, dead = _masked_inputs(rng, _window_pcm(), 128)
    (_, hist_t, err_t, done_t, it_t, sh_t), (_, hist_j, err_j, done_j, it_j, sh_j), vn_t, _ = (
        _run_both_transposed(g, prior, synds, vn, cn, dead, 128, "bfloat16", rng))
    for a, b in ((err_t, err_j), (done_t, done_j), (it_t, it_j), (sh_t, sh_j)):
        np.testing.assert_array_equal(a, b)
    read = np.broadcast_to((vn_t == -1)[:, None, :] & ~done_j[None, None, :], hist_t.shape)
    np.testing.assert_allclose(hist_t[read], hist_j[read], rtol=2**-7, atol=1e-2)


def test_bp_run_transposed_equals_batch_major(rng):
    """The transposed state layout and ``return_synd`` give the batch-major
    call's results, transposed; the bf16 history ring is not ported."""
    g, prior, synds, vn, cn, dead = _masked_inputs(rng, _low_degree_graph(rng), 64)
    garr = graph_tensors(g, "cpu")
    B, m = 64, g.m
    synd_t, cn_t, vn_t, err_t, hist, done = _transposed_inputs(rng, g, synds, vn, cn, dead, B)
    kw = dict(num_iter=9, history_mode="full", io_layout="slot_major", masked=True,
              return_synd=True)

    def run(layout, *state):
        s, h, e, v, c = state
        return tbp.bp_run(garr, tbp.bp_init_messages_sm(garr, prior, B), prior, s, h, e,
                          torch.from_numpy(done), torch.zeros(B, dtype=torch.int32),
                          vn_state=v, cn_state=c, state_layout=layout, **kw)

    tr = run("transposed", torch.from_numpy(synd_t), torch.from_numpy(hist),
             torch.from_numpy(err_t), torch.from_numpy(vn_t), torch.from_numpy(cn_t))
    bm = run("batch_major", torch.from_numpy(synds), torch.from_numpy(hist),
             torch.from_numpy(err_t.T.copy()), torch.from_numpy(vn), torch.from_numpy(cn))
    for a, b in ((tr[0], bm[0]), (tr[1], bm[1]), (tr[2].T, bm[2]), (tr[3], bm[3]),
                 (tr[4], bm[4]), (tr[5][:m].T, bm[5])):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="float32"):
        tbp.bp_run(garr, tbp.bp_init_messages_sm(garr, prior, B), prior,
                   torch.from_numpy(synds), torch.from_numpy(hist), torch.from_numpy(err_t.T),
                   torch.from_numpy(done), torch.zeros(B, dtype=torch.int32), num_iter=2,
                   io_layout="slot_major", hist_dtype="bfloat16")
