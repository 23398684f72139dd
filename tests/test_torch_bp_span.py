"""The fused BP span (``ops.bp_cuda.bp_span``, ``csrc/bp_span.cu``) around
what runs on the CPU: its plain version ``ops.bp.bp_loop`` against the JAX
package's ``bp_run``, the exit-check invariance its block-local exit relies
on, its shape gate and index tables, and the CPU dispatch.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Inputs are made with numpy from a seed and fed to both sides.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
from slidingwindowdecoder_torch.ops import bp as tbp
from slidingwindowdecoder_torch.ops import bp_cuda
from slidingwindowdecoder_torch.ops import decimation as tdec
from slidingwindowdecoder_torch.utils import cuda_build
from slidingwindowdecoder_tpu.graphs.tanner import graph_device_arrays
from slidingwindowdecoder_tpu.ops import bp as jbp

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@functools.cache
def _window72():
    """The interior window of the [[72]] x3 W=2 experiment at p=0.01 (PCM
    and channel probabilities): dv <= 6, like the flagship windows."""
    _, _, _, plan = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    w = plan.windows[1]
    return w.mat, np.asarray(w.prior, np.float64)


@functools.cache
def _graphs144():
    """The [[144]] W=3 window PCMs (216x1656, 216x1728) and the global DEM."""
    _, _, dem, plan = build_bb_window_experiment(144, 0.004, 12, 3, 1)
    return {"window0": plan.windows[0].mat, "window1": plan.windows[1].mat,
            "global": dem.chk}


def _inputs(rng, masked, B):
    """Prior, syndromes of channel-rate errors and, masked, a peeled
    decimation state deciding about a third of the VNs (its dead shots
    enter done, as in ``OSDWindow``)."""
    H, p = _window72()
    n = H.shape[1]
    prior = np.log((1 - p) / p).astype(np.float32)
    errs = (rng.random((B, n)) < p).astype(np.int8)
    synds = ((errs @ H.T) % 2).astype(np.uint8)
    g = compile_graph(H)
    vn = cn = None
    done = np.zeros(B, bool)
    if masked:
        garr = graph_tensors(g, "cpu")
        state = tdec.init_decimation_state(garr, torch.from_numpy(synds))
        state = tdec.vn_set_values(garr, *state, torch.from_numpy(rng.random((B, n)) < 1 / 3),
                                   torch.from_numpy(errs))
        vn, cn, _, dead = (x.numpy() for x in tdec.peel(garr, *state))
        done = dead
    return g, prior, synds, vn, cn, done


def _run_port(g, prior, synds, vn, cn, done, dtype, **kw):
    B, n = synds.shape[0], g.n
    garr = graph_tensors(g, "cpu")
    err0 = np.zeros((B, n), np.int8) if vn is None else np.where(vn != -1, vn, 0).astype(np.int8)
    hist, _, _, iters = tbp.fresh_bp_state(garr, B)
    out = tbp.bp_run(
        garr, tbp.bp_init_messages(garr, prior, B), prior, torch.from_numpy(synds), hist,
        torch.from_numpy(err0), torch.from_numpy(done), iters, msg_dtype=dtype,
        vn_state=None if vn is None else torch.from_numpy(vn),
        cn_state=None if cn is None else torch.from_numpy(cn), masked=vn is not None, **kw)
    return [np.asarray(x.float() if x.dtype == torch.bfloat16 else x) for x in out]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exit_check_invariance(rng, monkeypatch, masked, dtype):
    """Checking the all-done exit every 1, 4 or 10**9 iterations changes no
    output but the messages of shots that are done: the property the fused
    kernel's per-block exit relies on."""
    g, prior, synds, vn, cn, done = _inputs(rng, masked, 96)
    outs = []
    for every in (1, 4, 10**9):
        monkeypatch.setattr(tbp, "EXIT_CHECK_EVERY", every)
        outs.append(_run_port(g, prior, synds, vn, cn, done, dtype, num_iter=24,
                              freeze_messages=False, history_mode="tail"))
    mv0, hist0, err0, done0, it0 = outs[0]
    assert 0 < done0.sum() < len(done0)
    for mv, hist, err, dn, it in outs[1:]:
        np.testing.assert_array_equal(err, err0)
        np.testing.assert_array_equal(dn, done0)
        np.testing.assert_array_equal(it, it0)
        np.testing.assert_array_equal(hist, hist0)
        np.testing.assert_array_equal(mv[~done0], mv0[~done0])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_loop_matches_jax(rng, masked, dtype):
    """``bp_run`` on CPU tensors (``bp_span`` -> ``bp_loop``) against the JAX
    ``bp_run`` on the [[72]] window graph, B=128: f32 bit-equal; bf16 equal
    decisions, convergence and iterations, with history and messages within
    rtol 2**-7 (one bf16 ulp) and atol 1e-2 (XLA on the CPU may keep bf16
    intermediates in f32), as in ``tests/test_torch_bp.py``."""
    B = 128
    g, prior, synds, vn, cn, done = _inputs(rng, masked, B)
    kw = dict(num_iter=20, alpha=1.0, clip=50.0, freeze_messages=True, history_mode="full")
    before = bp_cuda.bp_span.plain_calls
    mv_t, hist_t, err_t, done_t, it_t = _run_port(g, prior, synds, vn, cn, done, dtype, **kw)
    assert bp_cuda.bp_span.plain_calls == before + 1

    garr_j = graph_device_arrays(g)
    sj = jnp.asarray(synds)
    err0 = np.zeros((B, g.n), np.int8) if vn is None else np.where(vn != -1, vn, 0)
    hist_j, _, _, it_j = jbp.fresh_bp_state(garr_j, B)
    out_j = jbp.bp_run(
        garr_j, jbp.bp_init_messages(garr_j, prior, B), prior, sj,
        jnp.full((B, g.n), -1, jnp.int8) if vn is None else jnp.asarray(vn),
        sj.astype(jnp.int8) if cn is None else jnp.asarray(cn), hist_j,
        jnp.asarray(err0, jnp.int8), jnp.asarray(done), it_j, msg_dtype=dtype,
        masked=masked, **kw)
    mv_j, hist_j, err_j, done_j, it_j = (np.asarray(x, np.float32) if i < 2 else np.asarray(x)
                                         for i, x in enumerate(out_j))
    assert 0 < (done_j & ~done).sum() < (~done).sum()  # some converge, some not
    np.testing.assert_array_equal(err_t, err_j)
    np.testing.assert_array_equal(done_t, done_j)
    np.testing.assert_array_equal(it_t, it_j)
    if dtype == "float32":
        np.testing.assert_array_equal(hist_t, hist_j)
        np.testing.assert_array_equal(mv_t, mv_j)
    else:
        np.testing.assert_allclose(hist_t, hist_j, rtol=2**-7, atol=1e-2)
        np.testing.assert_allclose(mv_t, mv_j, rtol=2**-7, atol=1e-2)


@pytest.mark.parametrize("graph,dtype,admitted,shots", [
    ("window0", torch.float32, True, 4),
    ("window0", torch.bfloat16, True, 8),
    ("window1", torch.float32, True, 4),
    ("window1", torch.bfloat16, True, 8),
    ("global", torch.float32, False, 0),
    ("global", torch.bfloat16, False, 0),
])
def test_gate(graph, dtype, admitted, shots):
    """The flagship windows fit 4 f32 or 8 bf16 shots per block; the
    global DEM graph (m_pad 960) fits none."""
    garr = graph_tensors(compile_graph(_graphs144()[graph]), "cpu")
    assert bp_cuda.bp_span_supported(garr, 512, dtype) is admitted
    assert bp_cuda.max_shots_per_block(garr, dtype) == shots
    if shots:
        assert bp_cuda.span_smem_bytes(garr, dtype, shots) <= bp_cuda.SMEM_MAX
        assert bp_cuda.span_smem_bytes(garr, dtype, shots + 1) > bp_cuda.SMEM_MAX
        # one block per SM: B=512 f32 and B=1024 bf16 give 128 blocks
        B = 512 if dtype == torch.float32 else 1024
        assert bp_cuda.shots_per_block(garr, B, dtype, 132) == shots
        assert bp_cuda.shots_per_block(garr, 64, dtype, 132) == 1


def test_smem_layout_at_window1():
    """The shared-memory totals written down in ``csrc/bp_span.cu``'s
    notes and PERF.md: 205,648 B for 4 f32 shots, 214,416 B for 8 bf16."""
    garr = graph_tensors(compile_graph(_graphs144()["window1"]), "cpu")
    assert bp_cuda.span_smem_bytes(garr, torch.float32, 4) == 205_648
    assert bp_cuda.span_smem_bytes(garr, torch.bfloat16, 8) == 214_416


@pytest.mark.parametrize("graph", ["window0", "window1"])
def test_span_tables_equal_garr(graph):
    """The wrapper's int16 tables are ``garr``'s index tables, and the
    degree table reproduces the validity mask."""
    g = compile_graph(_graphs144()[graph])
    garr = graph_tensors(g, "cpu")
    tables = bp_cuda.span_tables(garr)
    assert tables["cn_vn"].dtype == tables["vfc"].dtype == torch.int16
    assert torch.equal(tables["cn_vn"].long(), garr["cn_vn_clip"])
    assert torch.equal(tables["vfc"].long(), garr["vn_from_cn_flat"])
    assert torch.equal(tables["deg"].long(), torch.as_tensor(g.cn_valid_sm.sum(axis=0)))
    slots = torch.arange(g.dc)[:, None]
    assert torch.equal(slots < tables["deg"][None], garr["cn_valid_sm"])
    assert bp_cuda.span_tables(garr) is tables  # built once


def test_gate_rejects_valid_slots_out_of_order():
    """A check row whose valid slots are not its first ones is outside the
    kernel's walk of the first ``deg`` slots."""
    g = compile_graph(_window72()[0])
    garr = graph_tensors(g, "cpu")
    valid = garr["cn_valid_sm"].clone()
    row = int(np.nonzero(g.cn_degree < g.dc)[0][0])
    valid[0, row], valid[g.dc - 1, row] = False, True
    garr["cn_valid_sm"] = valid
    assert bp_cuda.span_tables(garr) is None
    assert not bp_cuda.bp_span_supported(garr, 512, torch.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_runs_the_plain_loop(rng, monkeypatch, masked):
    """``bp_run`` on CPU tensors counts one plain call of ``bp_span`` and
    never builds or launches a kernel."""
    def no_build(*_a, **_k):
        raise AssertionError("a CPU run must not build a kernel")

    monkeypatch.setattr(cuda_build, "load", no_build)
    monkeypatch.setattr(cuda_build, "build", no_build)
    g, prior, synds, vn, cn, done = _inputs(rng, masked, 32)
    span, cn_upd = bp_cuda.bp_span, bp_cuda.cn_update
    before = (span.plain_calls, span.launches, span.pinned_launches,
              cn_upd.launches, cn_upd.pinned_launches)
    _run_port(g, prior, synds, vn, cn, done, "float32", num_iter=6)
    after = (span.plain_calls, span.launches, span.pinned_launches,
             cn_upd.launches, cn_upd.pinned_launches)
    assert after == (before[0] + 1, *before[1:])
