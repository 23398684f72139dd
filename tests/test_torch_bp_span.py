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
    """The [[144]] W=3 window PCMs (216x1656, 216x1728), the global DEM, and
    the [[288]] W=4 windows (r=6): an edge one (576x4752) and an interior
    one (576x4896)."""
    _, _, dem, plan = build_bb_window_experiment(144, 0.004, 12, 3, 1)
    plan288 = build_bb_window_experiment(288, 0.005, 6, 4, 1)[3]
    return {"window0": plan.windows[0].mat, "window1": plan.windows[1].mat,
            "global": dem.chk, "w288_edge": plan288.windows[0].mat,
            "w288": plan288.windows[1].mat}


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


@pytest.mark.parametrize("graph,dtype,route,shots", [
    ("global", torch.float32, bp_cuda.WIDE, 1),
    ("global", torch.bfloat16, bp_cuda.WIDE, 2),
    ("w288", torch.float32, bp_cuda.WIDE, 2),
    ("w288", torch.bfloat16, bp_cuda.SHARED, 1),
    ("w288_edge", torch.float32, bp_cuda.SHARED, 1),
    ("window1", torch.float32, bp_cuda.SHARED, 4),
])
def test_route(graph, dtype, route, shots):
    """The table route each graph's calls take on the card, and its shots
    per block: the global DEM and the interior [[288]] W=4 window in f32
    take the wide route (the shared-table gate refuses them); a graph the
    shared-table route admits keeps it."""
    garr = graph_tensors(compile_graph(_graphs144()[graph]), "cpu")
    assert bp_cuda.span_route(garr, 512, dtype) == route
    assert bp_cuda.bp_span_supported(garr, 512, dtype) is (route == bp_cuda.SHARED)
    assert bp_cuda.bp_span_wide_supported(garr, 512, dtype)
    assert bp_cuda.max_shots_per_block(garr, dtype, route) == shots
    assert bp_cuda.span_smem_bytes(garr, dtype, shots, route) <= bp_cuda.SMEM_MAX
    assert bp_cuda.span_smem_bytes(garr, dtype, shots + 1, route) > bp_cuda.SMEM_MAX
    assert bp_cuda.shots_per_block(garr, 8192, dtype, 132, route) == shots


def test_wide_route_layout():
    """The wide route's shared memory holds per-shot state only: the totals
    written down in ``csrc/bp_span.cu``'s notes (180,272 B for one f32
    global shot, 95,504 B a bf16 one, 110,848 B an f32 [[288]] interior
    one), which are the shared-table layout less its tables and prior."""
    g = _graphs144()
    glob = graph_tensors(compile_graph(g["global"]), "cpu")
    w288 = graph_tensors(compile_graph(g["w288"]), "cpu")
    wide = bp_cuda.WIDE
    assert bp_cuda.span_smem_bytes(glob, torch.float32, 1, wide) == 180_272
    assert bp_cuda.span_smem_bytes(glob, torch.bfloat16, 1, wide) == 95_504
    assert bp_cuda.span_smem_bytes(glob, torch.bfloat16, 2, wide) == 190_992
    assert bp_cuda.span_smem_bytes(w288, torch.float32, 1, wide) == 110_848
    assert bp_cuda.span_smem_bytes(w288, torch.float32, 2, wide) == 221_680
    for garr in (glob, w288):
        n, m_pad, dc, dv = garr["n"], garr["m_pad"], garr["dc"], garr["dv"]
        tables = sum(-(-x // 16) * 16 for x in (4 * n, 2 * dc * m_pad, 2 * n * dv, 2 * m_pad))
        for dt in (torch.float32, torch.bfloat16):
            assert (bp_cuda.span_smem_bytes(garr, dt, 1)
                    == bp_cuda.span_smem_bytes(garr, dt, 1, wide) + tables)


@pytest.mark.parametrize("graph", ["global", "w288", "window1"])
def test_wide_tables_equal_garr(graph):
    """The wide route's tables hold ``garr``'s index tables as the bits of
    uint16 (the global DEM's fill index 33,600 and its slots past 32,767
    read back through the uint16 view), its degree table the validity
    mask; the shared-table route refuses the global DEM's indices."""
    g = compile_graph(_graphs144()[graph])
    garr = graph_tensors(g, "cpu")
    tables = bp_cuda.span_tables(garr, bp_cuda.WIDE)

    def u16(t):
        return t.to(torch.int32) & 0xFFFF

    assert tables["cn_vn"].dtype == tables["vfc"].dtype == torch.int16
    assert torch.equal(u16(tables["cn_vn"]).long(), garr["cn_vn_clip"])
    assert torch.equal(u16(tables["vfc"]).long(), garr["vn_from_cn_flat"])
    assert int(u16(tables["vfc"]).max()) == g.dc * g.m_pad  # the fill row
    slots = torch.arange(g.dc)[:, None]
    assert torch.equal(slots < tables["deg"][None], garr["cn_valid_sm"])
    assert bp_cuda.span_tables(garr, bp_cuda.WIDE) is tables  # built once
    assert (bp_cuda.span_tables(garr) is None) is (graph == "global")


def test_wide_gate_rejects_valid_slots_out_of_order():
    """The wide route walks each row's first ``deg`` slots too: a row whose
    valid slots are not its first ones is refused on both routes."""
    g = compile_graph(_window72()[0])
    garr = graph_tensors(g, "cpu")
    valid = garr["cn_valid_sm"].clone()
    row = int(np.nonzero(g.cn_degree < g.dc)[0][0])
    valid[0, row], valid[g.dc - 1, row] = False, True
    garr["cn_valid_sm"] = valid
    assert bp_cuda.span_tables(garr, bp_cuda.WIDE) is None
    assert bp_cuda.span_route(garr, 512, torch.float32) is None


@pytest.mark.parametrize("masked", [False, True])
def test_wide_graph_plain_loop_matches_jax(rng, masked):
    """The wide route's plain version on its own graph: ``bp_run`` on CPU
    tensors of the interior [[288]] W=4 window (576x4896) against the JAX
    ``bp_run``, f32, B=128, 12 iterations from channel-rate syndromes
    (masked: a third of the VNs decided at their true values and peeled):
    errors, convergence and iterations equal, history and messages
    bit-equal."""
    B = 128
    _, _, _, plan = build_bb_window_experiment(288, 0.005, 6, 4, 1)
    w = plan.windows[1]
    H, p = w.mat, np.asarray(w.prior, np.float64)
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
    kw = dict(num_iter=12, alpha=1.0, clip=50.0, freeze_messages=True, history_mode="full")
    mv_t, hist_t, err_t, done_t, it_t = _run_port(g, prior, synds, vn, cn, done, "float32",
                                                  **kw)
    garr_j = graph_device_arrays(g)
    sj = jnp.asarray(synds)
    err0 = np.zeros((B, n), np.int8) if vn is None else np.where(vn != -1, vn, 0)
    hist_j, _, _, it_j = jbp.fresh_bp_state(garr_j, B)
    out_j = jbp.bp_run(
        garr_j, jbp.bp_init_messages(garr_j, prior, B), prior, sj,
        jnp.full((B, n), -1, jnp.int8) if vn is None else jnp.asarray(vn),
        sj.astype(jnp.int8) if cn is None else jnp.asarray(cn), hist_j,
        jnp.asarray(err0, jnp.int8), jnp.asarray(done), it_j, msg_dtype="float32",
        masked=masked, **kw)
    mv_j, hist_j, err_j, done_j, it_j = (np.asarray(x, np.float32) if i < 2 else np.asarray(x)
                                         for i, x in enumerate(out_j))
    assert 0 < (done_j & ~done).sum() < (~done).sum()  # some converge, some not
    np.testing.assert_array_equal(err_t, err_j)
    np.testing.assert_array_equal(done_t, done_j)
    np.testing.assert_array_equal(it_t, it_j)
    np.testing.assert_array_equal(hist_t, hist_j)
    np.testing.assert_array_equal(mv_t, mv_j)


def test_smem_layout_at_window1():
    """The shared-memory totals written down in ``csrc/bp_span.cu``'s
    notes and PERF.md: 205,648 B for 4 f32 shots, 214,416 B for 8 bf16;
    the most a block holds at the flagship shapes (4 and 8), and the
    columns a block takes of a 300-column call on 132 SMs (3)."""
    garr = graph_tensors(compile_graph(_graphs144()["window1"]), "cpu")
    assert bp_cuda.span_smem_bytes(garr, torch.float32, 4) == 205_648
    assert bp_cuda.span_smem_bytes(garr, torch.bfloat16, 8) == 214_416
    assert bp_cuda.max_shots_per_block(garr, torch.float32) == 4
    assert bp_cuda.max_shots_per_block(garr, torch.bfloat16) == 8
    assert bp_cuda.shots_per_block(garr, 300, torch.float32, 132) == 3


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

    def counts():
        return (span.plain_calls, span.launches, span.pinned_launches, span.wide_launches,
                span.pinned_wide_launches, cn_upd.launches, cn_upd.pinned_launches)

    before = counts()
    _run_port(g, prior, synds, vn, cn, done, "float32", num_iter=6)
    assert counts() == (before[0] + 1, *before[1:])


@pytest.mark.parametrize("masked", [False, True])
def test_inplace_form_equals_copying_form(rng, masked):
    """``bp_span(inplace=True)`` through the plain path on a batch with rows
    done at entry: the outputs of the copying form (error, done,
    iterations, ring, ``synd_hat`` and the messages of every row not done
    at entry); the done rows' messages their inputs, which the copying
    form returns pinned at entry in masked mode; and the outputs are the
    caller's tensors (messages, ring, error, done, iterations), the
    caller's inputs left alone by the copying form but for the ring."""
    B = 96
    g, prior, synds, vn, cn, done = _inputs(rng, masked, B)
    done = done | (rng.random(B) < 0.15)
    garr = graph_tensors(g, "cpu")
    n = g.n
    err0 = np.zeros((B, n), np.int8) if vn is None else np.where(vn != -1, vn, 0).astype(np.int8)

    def call(inplace):
        args, kw = tbp.span_inputs(
            garr, tbp.bp_init_messages_sm(garr, prior, B).contiguous(), prior,
            torch.from_numpy(synds), torch.zeros((n, 4, B)), torch.from_numpy(err0.copy()),
            torch.from_numpy(done.copy()), torch.zeros(B, dtype=torch.int32), num_iter=20,
            history_mode="full", io_layout="slot_major", masked=masked, inplace=inplace,
            vn_state=None if vn is None else torch.from_numpy(vn),
            cn_state=None if cn is None else torch.from_numpy(cn))
        mine = [a.clone() for a in (args[1], args[7], args[8], args[9])]
        out = bp_cuda.bp_span(*args, **kw, return_synd=True, inplace=inplace)
        return args, mine, out

    args_c, entry_c, out_c = call(False)
    args_i, entry_i, out_i = call(True)
    d = torch.from_numpy(done)
    assert 0 < int((out_c[3] & ~d).sum()) < int((~d).sum())  # some converge, some not
    for k in range(1, 6):
        assert torch.equal(out_i[k], out_c[k]), k
    assert torch.equal(out_i[0][:, :, ~d], out_c[0][:, :, ~d])
    assert torch.equal(out_i[0][:, :, d], entry_i[0][:, :, d])
    if masked:
        assert not torch.equal(out_c[0][:, :, d], entry_c[0][:, :, d])
    for got, theirs in zip((out_i[0], out_i[1], out_i[2], out_i[3], out_i[4]),
                           (args_i[1], args_i[6], args_i[7], args_i[8], args_i[9])):
        assert got.data_ptr() == theirs.data_ptr()
    for theirs, before in zip((args_c[1], args_c[7], args_c[8], args_c[9]), entry_c):
        assert torch.equal(theirs, before)
    assert out_c[1].data_ptr() == args_c[6].data_ptr()  # the ring copy, written in place


def test_inplace_transposed_state_is_the_callers(rng):
    """``bp_run(inplace=True)`` with GDG's transposed carry: the [n, B]
    error it returns is the caller's tensor, and so are the slot-major
    messages, ring, done and iterations; the results equal the copying
    form's."""
    B = 64
    g, prior, synds, vn, cn, dead = _inputs(rng, True, B)
    garr = graph_tensors(g, "cpu")
    m, n, m_pad = g.m, g.n, g.m_pad
    synd_t = torch.zeros((m_pad, B), dtype=torch.int8)
    synd_t[:m] = torch.from_numpy(synds.T.astype(np.int8))
    cn_t = torch.full((m_pad, B), -1, dtype=torch.int8)
    cn_t[:m] = torch.from_numpy(cn.T)
    err_t = torch.from_numpy(np.where(vn != -1, vn, 0).astype(np.int8).T.copy())
    kw = dict(num_iter=6, return_synd=True, io_layout="slot_major", history_mode="tail",
              hist_update="slice", state_layout="transposed", masked=True,
              vn_state=torch.from_numpy(vn.T.copy()), cn_state=cn_t)

    def call(inplace):
        state = (tbp.bp_init_messages_sm(garr, prior, B).contiguous(), torch.zeros((n, 4, B)),
                 err_t.clone(), torch.from_numpy(dead.copy()), torch.zeros(B, dtype=torch.int32))
        mv, hist, err, done, iters = state
        out = tbp.bp_run(garr, mv, prior, synd_t, hist, err, done, iters, **kw, inplace=inplace)
        return state, out

    _, out_c = call(False)
    state, out_i = call(True)
    for a, b in zip(out_i[1:], out_c[1:]):
        assert torch.equal(a, b)
    for got, theirs in zip(out_i[:5], state):
        assert got.data_ptr() == theirs.data_ptr()
    assert out_i[2].shape == (n, B)


@pytest.mark.parametrize("decoder", ["gdg", "bpgd", "osd_window", "bposd"])
def test_decoders_inplace_equal_copying(monkeypatch, decoder):
    """Each decoder that passes ``bp_run(inplace=True)`` decodes a few bb72
    code-capacity shots on the CPU exactly as it does with the copying form
    forced (the same errors, convergence, iterations and metrics)."""
    from slidingwindowdecoder_torch.codes import bb_code_by_n
    from slidingwindowdecoder_torch.decoders import BPGD, BPOSD, GDG, OSDWindow
    from slidingwindowdecoder_torch.decoders import bpgd as mod_bpgd
    from slidingwindowdecoder_torch.decoders import bposd as mod_bposd
    from slidingwindowdecoder_torch.decoders import gdg as mod_gdg
    from slidingwindowdecoder_torch.decoders import osd_window as mod_osd_window

    code, _, _ = bb_code_by_n(72)
    r = np.random.default_rng(41)
    probs = 0.06 * (0.75 + 0.5 * r.random(code.N))
    synds = ((r.random((24, code.N)) < probs).astype(np.uint8) @ code.hx.T) % 2
    make, module = {
        "gdg": (lambda: GDG(code.hx, probs, max_iter=24, max_iter_per_step=6, max_step=12,
                            max_tree_depth=2, max_side_depth=4, max_tree_branch_step=6,
                            max_side_branch_step=6, ensemble_bucket=8, device="cpu"),
                mod_gdg),
        "bpgd": (lambda: BPGD(code.hx, probs, max_iter=24, max_step=20, device="cpu"),
                 mod_bpgd),
        "osd_window": (lambda: OSDWindow(code.hx, probs, pre_max_iter=6, post_max_iter=20,
                                         osd_method="osd_cs", osd_order=2, bucket=8,
                                         device="cpu"), mod_osd_window),
        "bposd": (lambda: BPOSD(code.hx, probs, max_iter=30, phase_a_iters=6,
                                phase_b_spans=(8, 16), bp_bucket=8, osd_method="osd_cs",
                                osd_order=2, device="cpu"), mod_bposd),
    }[decoder]
    calls = {"inplace": 0}
    real = module.bp_run

    def counted(*a, **k):
        calls["inplace"] += bool(k.get("inplace"))
        return real(*a, **k)

    monkeypatch.setattr(module, "bp_run", counted)
    got = make().decode_batch(synds)
    assert calls["inplace"] > 0
    monkeypatch.setattr(module, "bp_run", lambda *a, **k: real(*a, **{**k, "inplace": False}))
    want = make().decode_batch(synds)
    for k in ("error", "converged", "iterations", "min_pm"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
