"""The bfloat16 history ring: ``bp_run`` and GDG with ``hist_dtype="bfloat16"``
against the JAX package (CPU).

Inputs are made with numpy from a seed and fed to both sides. The JAX side
gets a bfloat16 history array (its ``bp_run`` takes the ring's dtype from
it) and runs its CN stage as the Pallas kernel in interpret mode, as its
own tests do (``tests/test_bp_pallas.py``), so its batches are multiples
of 128 columns.

``bp_run``: the messages are f32, so the f32 posteriors are bit-equal and
the ring, each write rounded once to bf16, must be bit-equal as bf16; so
must errors, convergence and iterations. GDG at bf16 messages and ring
(the JAX package's GDG parity knobs): errors, convergence and iterations
equal on every shot, ``min_pm`` within rtol 1e-6 (the port's exact f64
path metric against JAX's f32 sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.codes import bb_code_by_n
from slidingwindowdecoder_torch.decoders import GDG
from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.ops import bp as tbp
from slidingwindowdecoder_torch.ops import decimation as tdec
from slidingwindowdecoder_tpu.decoders import GDG as JGDG
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays
from slidingwindowdecoder_tpu.ops import bp as jbp
from test_torch_bp import _low_degree_graph  # VN degrees <= 6, as a DEM window's

B = 128


@pytest.fixture(autouse=True)
def one_thread():
    """The inputs are small, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _inputs(rng, masked):
    """On a random graph of VN degree <= 6 (XLA's CPU sum of a higher degree
    may interleave partial sums, ROADMAP section 3): prior, syndromes, VN
    and CN states (masked: about a third of the VNs decided, peeled), a
    random bf16 ring (entries no write reaches keep their values) and some
    shots done at entry."""
    H = _low_degree_graph(rng)
    g = compile_graph(H)
    n = H.shape[1]
    p = 0.04
    prior = np.log((1 - p) / p) * np.ones(n, np.float32)
    prior[::7] *= 0.5
    errs = (rng.random((B, n)) < p).astype(np.int8)
    synds = ((errs @ H.T) % 2).astype(np.uint8)
    vn = np.full((B, n), -1, np.int8)
    cn = synds.astype(np.int8)
    if masked:
        garr = graph_tensors(g, "cpu")
        state = tdec.init_decimation_state(garr, torch.from_numpy(synds))
        state = tdec.vn_set_values(garr, *state, torch.from_numpy(rng.random((B, n)) < 1 / 3),
                                   torch.from_numpy(errs))
        vn, cn, _, _ = (x.numpy() for x in tdec.peel(garr, *state))
    hist = torch.from_numpy(rng.standard_normal((n, 4, B)).astype(np.float32) * 8)
    done = rng.random(B) < 0.1
    return g, prior, synds, vn, cn, hist.to(torch.bfloat16), done


def _bits(x):
    """bf16 values as their int16 bit patterns (torch or JAX arrays)."""
    if torch.is_tensor(x):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("history_mode", ["full", "tail"])
@pytest.mark.parametrize("layout", ["batch_major", "transposed"])
@pytest.mark.parametrize("masked", [False, True])
def test_bp_run_bf16_ring_matches_jax(rng, masked, layout, history_mode):
    """``bp_run`` with a bf16 ring, unmasked and pinned, with batch-major
    and transposed states (slot-major messages and ring in the transposed
    form, the GDG burst's), 10 f32 iterations from fresh messages: the ring
    bit-equal as bf16, and errors, convergence and iterations equal."""
    g, prior, synds, vn, cn, hist, done = _inputs(rng, masked)
    m, n, m_pad = g.m, g.n, g.m_pad
    garr_t, garr_j = graph_tensors(g, "cpu"), graph_device_arrays(g)
    err0 = np.where(vn != -1, vn, 0).astype(np.int8)
    it0 = np.zeros(B, np.int32)
    kw = dict(num_iter=10, alpha=1.0, clip=50.0, history_mode=history_mode)
    if layout == "transposed":
        synd = np.zeros((m_pad, B), np.int8)
        synd[:m] = synds.T
        cn_s = np.full((m_pad, B), -1, np.int8)
        cn_s[:m] = cn.T
        vn_s, err_s, hist_t, hist_j = vn.T.copy(), err0.T.copy(), hist, hist
        kw.update(io_layout="slot_major", state_layout="transposed")
        mv_t = tbp.bp_init_messages_sm(garr_t, prior, B)
        mv_j = jbp.bp_init_messages_sm(garr_j, prior, B)
    else:
        synd, cn_s, vn_s, err_s = synds, cn, vn, err0
        hist_t = hist.permute(2, 0, 1).contiguous()
        hist_j = hist_t
        mv_t = tbp.bp_init_messages(garr_t, prior, B)
        mv_j = jbp.bp_init_messages(garr_j, prior, B)
    out_t = tbp.bp_run(
        garr_t, mv_t, prior, torch.from_numpy(synd), hist_t.clone(), torch.from_numpy(err_s),
        torch.from_numpy(done), torch.from_numpy(it0), vn_state=torch.from_numpy(vn_s),
        cn_state=torch.from_numpy(cn_s), masked=masked, hist_dtype="bfloat16", **kw)
    out_j = jbp.bp_run(
        garr_j, mv_j, prior, jnp.asarray(synd), jnp.asarray(vn_s), jnp.asarray(cn_s),
        jnp.asarray(hist_j.float().numpy(), jnp.bfloat16), jnp.asarray(err_s),
        jnp.asarray(done), jnp.asarray(it0), masked=masked, cn_engine="pallas_interpret",
        **kw)
    assert out_t[1].dtype == torch.bfloat16 and out_j[1].dtype == jnp.bfloat16
    done_j = np.asarray(out_j[3])
    assert 0 < (done_j & ~done).sum() < (~done).sum()  # some converge, some do not
    np.testing.assert_array_equal(_bits(out_t[1]), _bits(out_j[1]))
    for k, (a, b) in {"error": (out_t[2], out_j[2]), "done": (out_t[3], out_j[3]),
                      "iters": (out_t[4], out_j[4])}.items():
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=k)
    # the ring was written: a changed entry holds a bf16 posterior
    assert (_bits(out_t[1]) != _bits(hist_t)).any()


def test_bp_run_hist_dtype_checks(rng):
    """``hist_dtype`` must name the ring's dtype, float32 or bfloat16."""
    g, prior, synds, _, _, hist, done = _inputs(rng, False)
    garr = graph_tensors(g, "cpu")
    args = (garr, tbp.bp_init_messages(garr, prior, B), prior, torch.from_numpy(synds))
    state = (torch.zeros((B, g.n), dtype=torch.int8), torch.from_numpy(done),
             torch.zeros(B, dtype=torch.int32))
    ring = hist.permute(2, 0, 1)
    with pytest.raises(ValueError, match="hist_dtype"):
        tbp.bp_run(*args, ring, *state, num_iter=2, hist_dtype="float16")
    with pytest.raises(ValueError, match="hist_dtype"):
        tbp.bp_run(*args, ring, *state, num_iter=2)  # a bf16 ring named float32
    out = tbp.bp_run(*args, ring, *state, num_iter=2, hist_dtype="bfloat16")
    assert out[1].dtype == torch.bfloat16


# tests/test_gdg.py:241-313's knobs (22 branches, D_max 40)
KW = dict(max_iter=24, max_iter_per_step=6, max_step=40, max_tree_depth=3,
          max_side_depth=10, max_tree_branch_step=20, max_side_branch_step=20,
          msg_dtype="bfloat16", hist_dtype="bfloat16", ensemble_bucket=64)


@pytest.fixture(scope="module")
def gdg_inputs():
    """bb72 ``hx`` syndromes at p=0.13 with jittered priors, seed 7, 128
    shots (half of them then reach the ensemble)."""
    code, _, _ = bb_code_by_n(72)
    rng = np.random.default_rng(7)
    probs = 0.13 * (0.75 + 0.5 * rng.random(code.N))
    errs = (rng.random((128, code.N)) < probs).astype(np.uint8)
    return code, probs, ((errs @ code.hx.T) % 2).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_gdg(gdg_inputs):
    """The JAX host-stepped GDG at bf16 messages and ring, its CN stage in
    interpret-mode Pallas (64-shot buckets: 1408 columns)."""
    code, probs, synds = gdg_inputs
    return JGDG(code.hx, probs, ensemble_mode="host_loop", cn_engine="pallas_interpret",
                **KW).decode_batch(synds)


@pytest.mark.parametrize("mode", ["host_loop", "spans"])
def test_gdg_bf16_ring_matches_jax(gdg_inputs, jax_gdg, mode):
    """GDG with ``msg_dtype="bfloat16", hist_dtype="bfloat16"``, the
    port's host-stepped form and its spans form (row buckets of 128
    columns), against the JAX package: errors, convergence and iterations
    equal on every shot."""
    code, probs, synds = gdg_inputs
    rj = jax_gdg
    assert (rj.iterations > KW["max_iter"]).sum() >= 32  # the ensemble ran
    rt = GDG(code.hx, probs, ensemble_mode=mode, row_bucket=128, device="cpu",
             **KW).decode_batch(synds)
    for k in ("error", "converged", "iterations"):
        np.testing.assert_array_equal(getattr(rt, k), getattr(rj, k), err_msg=k)
    np.testing.assert_allclose(rt.min_pm, rj.min_pm, rtol=1e-6)
