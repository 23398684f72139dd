"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card (Hopper, ``sm_90a``) and ``nvcc``; they skip
without one. Run them there with
``python -m pytest tests/test_torch_cuda.py -q``.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cn_kernel_bit_exact(card, dtype):
    from slidingwindowdecoder_torch.ops.bp import _cn_update_sm
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update

    gen = torch.Generator(device=card).manual_seed(3)
    dc, m_pad, B = 9, 64, 300
    valid = torch.rand((dc, m_pad), generator=gen, device=card) < 0.8
    valid[:, -1] = False  # an inert pad row
    mv = torch.randn((dc, m_pad, B), generator=gen, device=card) * 40
    mv[1, ::3] = -mv[0, ::3]
    mv[2, ::4] = 0.0
    mv = mv.to(dtype)
    parity = torch.randint(0, 2, (m_pad, B), generator=gen, device=card,
                           dtype=torch.int32)
    before = cn_update.launches
    out = cn_update(mv, valid, parity, alpha=0.625, clip=50.0)
    assert cn_update.launches == before + 1
    assert torch.equal(out, _cn_update_sm(mv, valid, parity, alpha=0.625, clip=50.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cn_pinned_kernel_bit_exact(card, dtype):
    """The pinned (masked-BP) kernel: pins at the dtype-rounded PIN, whole
    checks pinned, ties, zeros and values beyond +-clip."""
    from slidingwindowdecoder_torch.ops.bp import PIN, _cn_update_sm
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update

    gen = torch.Generator(device=card).manual_seed(4)
    dc, m_pad, B = 9, 64, 300
    valid = torch.rand((dc, m_pad), generator=gen, device=card) < 0.8
    valid[:, -1] = False
    mv = torch.randn((dc, m_pad, B), generator=gen, device=card) * 40
    mv[1, ::3] = -mv[0, ::3]
    mv[2, ::4] = 0.0
    mv = mv.to(dtype)
    mv[torch.rand(mv.shape, generator=gen, device=card) < 0.3] = PIN
    mv[:, ::7] = PIN
    parity = torch.randint(0, 2, (m_pad, B), generator=gen, device=card,
                           dtype=torch.int32)
    before = cn_update.pinned_launches, cn_update.launches
    out = cn_update(mv, valid, parity, alpha=0.625, clip=50.0, pinned=True)
    assert (cn_update.pinned_launches, cn_update.launches) == (before[0] + 1, before[1])
    ref = _cn_update_sm(mv, valid, parity, alpha=0.625, clip=50.0, pinned=True)
    assert torch.equal(out, ref)


def test_gj_kernel_bit_exact(card):
    from slidingwindowdecoder_torch.ops.gf2_cuda import gauss_jordan_key
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        gf2_rank_packed,
        ordered_gauss_jordan_key,
        pack_rows_host,
    )

    rng = np.random.default_rng(5)
    base = (rng.random((40, 150)) < 0.1).astype(np.uint8)
    H = np.vstack([base, base[:6]])  # rank-deficient
    m, n = H.shape
    rank = gf2_rank_packed(H)
    Hw = torch.as_tensor(pack_rows_host(H).view(np.int32), device=card)
    synd = torch.as_tensor(rng.integers(0, 2, (33, m)), dtype=torch.uint8, device=card)
    key = torch.as_tensor(rng.integers(0, 8, (33, n)), dtype=torch.float32, device=card)
    before = gauss_jordan_key.launches
    out = gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank)
    assert gauss_jordan_key.launches == before + 1
    ref = ordered_gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k
    assert bool(out["inconsistent"].any())


def _bp_span_case(masked, dtype, B, seed, spec=None):
    """bp_run inputs on the [[72]] x3 W=2 window graph (72x468 in the first
    window), or on ``spec``'s PCM and prior, with real-looking syndromes
    and, masked, a peeled decimation state that decides about a third of
    the VNs."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.ops import decimation

    if spec is None:
        spec = build_bb_window_experiment(72, 0.01, 3, 2, 1)[3].windows[1]
    H = spec.mat
    rng = np.random.default_rng(seed)
    n = H.shape[1]
    p = np.asarray(spec.prior, np.float64)
    prior = np.log((1 - p) / p).astype(np.float32)
    errs = (rng.random((B, n)) < p).astype(np.int8)
    synds = torch.as_tensor((errs @ H.T) % 2, dtype=torch.uint8)
    garr = graph_tensors(compile_graph(H), "cpu")
    kw = dict(num_iter=30, msg_dtype=dtype, freeze_messages=False, history_mode="tail",
              io_layout="slot_major")
    vn = cn = None
    err0 = torch.zeros((B, n), dtype=torch.int8)
    if masked:
        state = decimation.init_decimation_state(garr, synds)
        state = decimation.vn_set_values(
            garr, *state, torch.as_tensor(rng.random((B, n)) < 1 / 3),
            torch.as_tensor(errs))
        vn, cn, _, dead = decimation.peel(garr, *state)
        err0 = torch.where(vn != -1, vn, 0).to(torch.int8)
        kw.update(vn_state=vn, cn_state=cn, masked=True)
    done0 = torch.as_tensor(rng.random(B) < 0.1)  # some shots done at entry
    return H, prior, synds, err0, done0, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bp_span_smem_layout_matches_kernel(card, dtype):
    """The gate's shared-memory count (``span_smem_bytes``) equals the
    kernel's own layout (``bp_span_smem_bytes``) on the [[72]] and the
    flagship [[144]] window graphs and the [[288]] W=4 edge window (one f32
    column), at every block size the gate allows."""
    import ctypes

    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    fn = cuda_build.load(bp_cuda.SPAN_SOURCE).bp_span_smem_bytes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    for code, p, rounds, w, which in ((72, 0.01, 3, 2, 1), (144, 0.004, 12, 3, 1),
                                      (288, 0.005, 6, 4, 0)):
        H = build_bb_window_experiment(code, p, rounds, w, 1)[3].windows[which].mat
        garr = graph_tensors(compile_graph(H), "cpu")
        shots = bp_cuda.max_shots_per_block(garr, dtype)
        assert shots >= 1
        args = (dtype.itemsize, garr["n"], garr["m_pad"], garr["dc"], garr["dv"])
        for s in range(1, shots + 1):
            assert fn(*args, s) == bp_cuda.span_smem_bytes(garr, dtype, s)


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bp_span_kernel_matches_plain_loop(card, masked, dtype, freeze):
    """``bp_run`` on the card (one launch of ``bp_span.cu``) against the
    plain loop on the CPU, B=300 (a ragged last block): error, done,
    iterations and history bit-equal, and the messages of every shot that
    is not done (of every shot with ``freeze_messages=True``)."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops.bp import bp_init_messages_sm, bp_run
    from slidingwindowdecoder_torch.ops.bp_cuda import bp_span

    B = 300
    H, prior, synds, err0, done0, kw = _bp_span_case(masked, dtype, B, 7)
    kw["freeze_messages"] = freeze
    outs = []
    for dev in ("cpu", card):
        garr = graph_tensors(compile_graph(H), dev)
        to = (lambda t: t.to(dev) if torch.is_tensor(t) else t)
        before = bp_span.launches, bp_span.pinned_launches, bp_span.plain_calls
        outs.append([x.cpu() for x in bp_run(
            garr, bp_init_messages_sm(garr, prior, B, dtype), prior, synds.to(dev),
            torch.zeros((H.shape[1], 4, B), device=dev), err0.to(dev), done0.to(dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            **{k: to(v) for k, v in kw.items()})])
        after = bp_span.launches, bp_span.pinned_launches, bp_span.plain_calls
        want = (0, 0, 1) if dev == "cpu" else ((0, 1, 0) if masked else (1, 0, 0))
        assert tuple(a - b for a, b in zip(after, before)) == want
    (mv_p, hist_p, err_p, done_p, it_p), (mv_k, hist_k, err_k, done_k, it_k) = outs
    assert 0 < int(done_p.sum()) < B
    assert torch.equal(err_k, err_p) and torch.equal(done_k, done_p)
    assert torch.equal(it_k, it_p) and torch.equal(hist_k, hist_p)
    keep = torch.ones_like(done_p) if freeze else ~done_p
    assert torch.equal(mv_k[:, :, keep], mv_p[:, :, keep])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bp_span_pinned_synd_hat_matches_plain_loop(card, dtype):
    """The GDG burst's form: masked ``bp_run`` with the transposed state,
    ``return_synd``, the slice history update and 6 iterations with tail
    history, on the card (one ``bp_span_pinned`` launch) against the plain
    loop on the CPU: error, done, iterations, history, ``synd_hat`` and the
    messages of every shot not done bit-equal; a shot done at entry keeps
    its target syndrome in ``synd_hat``."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops.bp import bp_init_messages_sm, bp_run
    from slidingwindowdecoder_torch.ops.bp_cuda import bp_span

    B = 300
    H, prior, synds, err0, done0, kw = _bp_span_case(True, dtype, B, 9)
    g = compile_graph(H)
    m, n, m_pad = g.m, g.n, g.m_pad
    synd_t = torch.zeros((m_pad, B), dtype=torch.int8)
    synd_t[:m] = synds.T.to(torch.int8)
    cn_t = torch.full((m_pad, B), -1, dtype=torch.int8)
    cn_t[:m] = kw["cn_state"].T
    kw.update(num_iter=6, freeze_messages=True, vn_state=kw["vn_state"].T.contiguous(),
              cn_state=cn_t, state_layout="transposed", return_synd=True,
              hist_update="slice")
    outs = []
    for dev in ("cpu", card):
        garr = graph_tensors(g, dev)
        to = (lambda t: t.to(dev) if torch.is_tensor(t) else t)
        before = bp_span.pinned_launches
        outs.append([x.cpu() for x in bp_run(
            garr, bp_init_messages_sm(garr, prior, B, dtype), prior, synd_t.to(dev),
            torch.zeros((n, 4, B), device=dev), err0.T.contiguous().to(dev),
            done0.to(dev), torch.zeros(B, dtype=torch.int32, device=dev),
            **{k: to(v) for k, v in kw.items()})])
        assert bp_span.pinned_launches == before + (dev != "cpu")
    (mv_p, hist_p, err_p, done_p, it_p, sh_p), (mv_k, hist_k, err_k, done_k, it_k, sh_k) = outs
    assert 0 < int(done_p.sum()) < B and err_p.shape == (n, B) and sh_p.shape == (m_pad, B)
    for a, b in ((err_k, err_p), (done_k, done_p), (it_k, it_p), (hist_k, hist_p),
                 (sh_k, sh_p), (mv_k[:, :, ~done_p], mv_p[:, :, ~done_p])):
        assert torch.equal(a, b)
    assert torch.equal(sh_k[:, done0], synd_t[:, done0]) and not sh_k[m:].any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bp_span_bf16_ring_matches_plain_loop(card, masked, dtype):
    """The four entry points with a bf16 history ring (message dtype x
    mode): ``bp_run`` with ``hist_dtype="bfloat16"`` on the card (one
    launch, counted in ``bf16_ring_launches`` unmasked and in
    ``pinned_bf16_ring_launches`` masked) against the plain loop on
    the CPU, B=300, the ring written from the first iteration over random
    entry values: the ring bit-equal as bf16, error, done and iterations
    equal, and the messages of every shot not done."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops.bp import bp_init_messages_sm, bp_run
    from slidingwindowdecoder_torch.ops.bp_cuda import bp_span

    B = 300
    H, prior, synds, err0, done0, kw = _bp_span_case(masked, dtype, B, 13)
    n = H.shape[1]
    kw.update(history_mode="full", hist_dtype="bfloat16")
    gen = torch.Generator().manual_seed(13)
    ring0 = (torch.randn((n, 4, B), generator=gen) * 8).to(torch.bfloat16)
    outs = []
    for dev in ("cpu", card):
        garr = graph_tensors(compile_graph(H), dev)
        to = (lambda t: t.to(dev) if torch.is_tensor(t) else t)
        counts = (lambda: (bp_span.bf16_ring_launches, bp_span.pinned_bf16_ring_launches,
                           bp_span.plain_calls))
        before = counts()
        outs.append([x.cpu() for x in bp_run(
            garr, bp_init_messages_sm(garr, prior, B, dtype), prior, synds.to(dev),
            ring0.to(dev), err0.to(dev), done0.to(dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            **{k: to(v) for k, v in kw.items()})])
        ran = tuple(a - b for a, b in zip(counts(), before))
        assert ran == ((0, 0, 1) if dev == "cpu" else (0, 1, 0) if masked else (1, 0, 0))
    (mv_p, hist_p, err_p, done_p, it_p), (mv_k, hist_k, err_k, done_k, it_k) = outs
    assert hist_k.dtype == torch.bfloat16 and 0 < int(done_p.sum()) < B
    assert torch.equal(hist_k.view(torch.int16), hist_p.view(torch.int16))
    assert not torch.equal(hist_p.view(torch.int16), ring0.view(torch.int16))
    assert torch.equal(err_k, err_p) and torch.equal(done_k, done_p)
    assert torch.equal(it_k, it_p)
    assert torch.equal(mv_k[:, :, ~done_p], mv_p[:, :, ~done_p])


@pytest.mark.parametrize("ring", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bp_span_wide_route_matches_plain_loop(card, masked, dtype, ring):
    """The wide (global-table) route forced (``bp_cuda._launch_span``, which
    ``bp_span`` calls on the route ``span_route`` names) on the [[72]]
    window graph, B=300 (a ragged last block), every entry point (message
    dtype x mode x ring dtype): one launch counted in ``wide_launches`` or
    ``pinned_wide_launches``, and the plain loop's outputs on the CPU:
    error, done, iterations and the ring bit-equal, and the messages of
    every shot not done."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.ops.bp import bp_init_messages_sm, span_inputs

    B = 300
    H, prior, synds, err0, done0, kw = _bp_span_case(masked, dtype, B, 17)
    n = H.shape[1]
    kw.update(history_mode="full")
    ring0 = (torch.randn((n, 4, B), generator=torch.Generator().manual_seed(17)) * 8).to(ring)
    span = bp_cuda.bp_span
    launch = {"cpu": span, card: functools.partial(bp_cuda._launch_span, bp_cuda.WIDE)}
    outs = []
    for dev in ("cpu", card):
        garr = graph_tensors(compile_graph(H), dev)
        to = (lambda t: t.to(dev) if torch.is_tensor(t) else t)
        args, skw = span_inputs(
            garr, bp_init_messages_sm(garr, prior, B, dtype), prior, synds.to(dev),
            ring0.to(dev), err0.to(dev), done0.to(dev),
            torch.zeros(B, dtype=torch.int32, device=dev), **{k: to(v) for k, v in kw.items()})
        before = span.wide_launches, span.pinned_wide_launches, span.launches, span.plain_calls
        outs.append([x.cpu() for x in launch[dev](*args, **skw)])
        after = span.wide_launches, span.pinned_wide_launches, span.launches, span.plain_calls
        want = ((0, 0, 0, 1) if dev == "cpu" else (0, 1, 0, 0) if masked else (1, 0, 0, 0))
        assert tuple(a - b for a, b in zip(after, before)) == want
    (mv_p, hist_p, err_p, done_p, it_p), (mv_k, hist_k, err_k, done_k, it_k) = outs
    assert hist_k.dtype == ring and 0 < int(done_p.sum()) < B
    assert torch.equal(hist_k.float(), hist_p.float())
    assert torch.equal(err_k, err_p) and torch.equal(done_k, done_p)
    assert torch.equal(it_k, it_p)
    assert torch.equal(mv_k[:, :, ~done_p], mv_p[:, :, ~done_p])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["288w4", "global"])
def test_bp_span_wide_route_at_its_shapes(card, which, dtype, masked):
    """``bp_run`` on the graphs the wide route serves, an interior [[288]]
    W=4 window (576x4896; the shared-table route takes its bf16 calls) and
    the [[144]] global DEM (936x8784): on the card one launch of the route
    that ``span_route`` names and no ``cn_update`` launch, against the
    plain loop on the CPU, error, done, iterations and history bit-equal,
    and the messages of every shot not done."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.ops.bp import bp_init_messages_sm, bp_run

    B = 24
    H, prior, synds, err0, done0, kw = _bp_span_case(masked, dtype, B, 19, _wide_spec(which))
    n = H.shape[1]
    kw["num_iter"] = 20
    span, cn = bp_cuda.bp_span, bp_cuda.cn_update
    route = bp_cuda.span_route(graph_tensors(compile_graph(H), "cpu"), B,
                               torch.float32 if dtype == "float32" else torch.bfloat16)
    assert route == (bp_cuda.SHARED if (which, dtype) == ("288w4", "bfloat16") else bp_cuda.WIDE)
    counter = f"{'pinned_' if masked else ''}{'wide_' if route == bp_cuda.WIDE else ''}launches"
    outs = []
    for dev in ("cpu", card):
        garr = graph_tensors(compile_graph(H), dev)
        to = (lambda t: t.to(dev) if torch.is_tensor(t) else t)
        before = getattr(span, counter), cn.launches + cn.pinned_launches
        outs.append([x.cpu() for x in bp_run(
            garr, bp_init_messages_sm(garr, prior, B, dtype), prior, synds.to(dev),
            torch.zeros((n, 4, B), device=dev), err0.to(dev), done0.to(dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            **{k: to(v) for k, v in kw.items()})])
        after = getattr(span, counter), cn.launches + cn.pinned_launches
        assert (after[0] - before[0], after[1] - before[1]) == ((0, 0) if dev == "cpu"
                                                                else (1, 0))
    (mv_p, hist_p, err_p, done_p, it_p), (mv_k, hist_k, err_k, done_k, it_k) = outs
    assert int(done_p.sum()) < B
    assert torch.equal(err_k, err_p) and torch.equal(done_k, done_p)
    assert torch.equal(it_k, it_p) and torch.equal(hist_k, hist_p)
    assert torch.equal(mv_k[:, :, ~done_p], mv_p[:, :, ~done_p])


def test_bp_span_wide_layout_matches_kernel(card):
    """The wide route's shared-memory count (``span_smem_bytes`` with
    ``route=WIDE``) equals the kernel's own layout
    (``bp_span_wide_smem_bytes``) at the [[72]] window, an interior [[288]]
    W=4 window and the [[144]] global DEM, in both dtypes, at every block
    size the route allows."""
    import ctypes

    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    fn = cuda_build.load(bp_cuda.SPAN_SOURCE).bp_span_wide_smem_bytes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    specs = [build_bb_window_experiment(72, 0.01, 3, 2, 1)[3].windows[1],
             _wide_spec("288w4"), _wide_spec("global")]
    for spec in specs:
        garr = graph_tensors(compile_graph(spec.mat), "cpu")
        for dtype in (torch.float32, torch.bfloat16):
            shots = bp_cuda.max_shots_per_block(garr, dtype, bp_cuda.WIDE)
            assert shots >= 1
            for s in range(1, shots + 1):
                assert fn(dtype.itemsize, garr["n"], garr["m_pad"], garr["dc"], garr["dv"],
                          s) == bp_cuda.span_smem_bytes(garr, dtype, s, bp_cuda.WIDE)


def _span_args(H, prior, synds, err0, done0, kw, dev, ring=torch.float32, seed=0):
    """``span_inputs``' (args, kw) of a ``_bp_span_case`` on ``dev``, the
    ring written from the first iteration over random entry values."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops.bp import bp_init_messages_sm, span_inputs

    B, n = synds.shape[0], H.shape[1]
    garr = graph_tensors(compile_graph(H), dev)
    ring0 = (torch.randn((n, 4, B), generator=torch.Generator().manual_seed(seed)) * 8).to(ring)
    to = (lambda t: t.to(dev) if torch.is_tensor(t) else t)
    kw = {**kw, "history_mode": "full", "freeze_messages": True}
    mdt = kw.pop("msg_dtype")
    return span_inputs(
        garr, bp_init_messages_sm(garr, prior, B, mdt).contiguous(), prior, synds.to(dev),
        ring0.to(dev), err0.to(dev, copy=True), done0.to(dev, copy=True),
        torch.zeros(B, dtype=torch.int32, device=dev), msg_dtype=mdt,
        **{k: to(v) for k, v in kw.items()}, inplace=True)


def _inplace_pair(card, args_c, kw_c, args_k, kw_k, route="shared"):
    """The kernel in place on the card on ``route`` (its outputs must be
    the caller's tensors) against ``bp_loop(keep_done=True)`` on the CPU:
    every output bit-exact, the messages of every column included, and
    the columns done at entry untouched byte for byte on the card."""
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.ops.bp import bp_loop

    entry = [t.clone() for t in (args_k[1], args_k[6], args_k[7], args_k[8], args_k[9])]
    done0 = args_k[8].clone()
    counter = (f"{'pinned_' if kw_k['masked'] else ''}"
               f"{'wide_' if route == bp_cuda.WIDE else ''}launches")
    before = getattr(bp_cuda.bp_span, counter)
    out_k = bp_cuda._launch_span(route, *args_k, **kw_k, inplace=True)
    torch.cuda.synchronize()
    assert getattr(bp_cuda.bp_span, counter) == before + 1
    for got, mine in zip(out_k[:5], (args_k[1], args_k[6], args_k[7], args_k[8], args_k[9])):
        assert got.data_ptr() == mine.data_ptr()  # the caller's storage
    ref = bp_loop(*args_c, **kw_c, keep_done=True)
    names = ("messages", "ring", "error", "done", "iters", "synd_hat")
    for name, a, b in zip(names, out_k, ref):
        a = a.cpu()
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), name
    d = done0
    assert torch.equal(out_k[0][:, :, d], entry[0][:, :, d])  # messages
    assert torch.equal(out_k[1][:, :, d].float(), entry[1][:, :, d].float())  # ring
    assert torch.equal(out_k[2][d], entry[2][d])  # error
    assert torch.equal(out_k[4][d], entry[4][d])  # iterations
    return ref


@pytest.mark.parametrize("route", ["shared", "wide"])
@pytest.mark.parametrize("ring", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bp_span_inplace_matches_plain_loop(card, masked, dtype, ring, route):
    """Either table route in its in-place form, every entry point (message
    dtype x mode x ring dtype), B=300 with columns done at entry scattered
    through the batch: one launch, the caller's tensors returned, every
    output bit-exact against ``bp_loop(keep_done=True)`` on the CPU
    (``synd_hat`` too, masked), and the done columns' messages, ring, error
    and iterations untouched."""
    B = 300
    H, prior, synds, err0, done0, kw = _bp_span_case(masked, dtype, B, 23)
    kw["freeze_messages"] = True
    args_c, kw_c = _span_args(H, prior, synds, err0, done0, kw, "cpu", ring, 23)
    args_k, kw_k = _span_args(H, prior, synds, err0, done0, kw, card, ring, 23)
    kw_c["return_synd"] = kw_k["return_synd"] = masked
    ref = _inplace_pair(card, args_c, kw_c, args_k, kw_k, route)
    assert 0 < int((ref[3] & ~done0).sum()) < int((~done0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bp_span_copying_form_pins_done_columns(card, dtype):
    """The shared-table route's copying form, masked, with the VN states
    in the GDG carry's transposed layout (read through their strides),
    B=300 with columns done at entry: the kernel itself loads the done
    columns and pins their messages at their decided VNs' edges and invalid
    slots, as the JAX loop pins every column at entry, so every column's
    messages (and every other output) equal ``bp_loop``'s on the CPU; the
    caller's messages are left as they came."""
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.ops.bp import bp_loop

    B = 300
    H, prior, synds, err0, done0, kw = _bp_span_case(True, dtype, B, 41)
    kw["vn_state"] = kw["vn_state"].T.contiguous().T  # [B, n] at strides (1, B)
    args_c, kw_c = _span_args(H, prior, synds, err0, done0, kw, "cpu", seed=41)
    args_k, kw_k = _span_args(H, prior, synds, err0, done0, kw, card, seed=41)
    kw_c["return_synd"] = kw_k["return_synd"] = True
    mv0 = args_k[1].clone()
    before = bp_cuda.bp_span.pinned_launches
    out_k = bp_cuda.bp_span(*args_k, **kw_k)
    torch.cuda.synchronize()
    assert bp_cuda.bp_span.pinned_launches == before + 1
    assert torch.equal(args_k[1], mv0) and out_k[0].data_ptr() != args_k[1].data_ptr()
    ref = bp_loop(*args_c, **kw_c)
    for name, a, b in zip(("messages", "ring", "error", "done", "iters", "synd_hat"), out_k, ref):
        a = a.cpu()
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), name
    assert int(done0.sum()) > 0


@pytest.mark.parametrize("case", ["all_done", "one_column", "ragged", "one_slow",
                                  "mostly_done"])
def test_bp_span_edge_cases(card, case):
    """The shared-table route at its edges, in place and against
    ``bp_loop(keep_done=True)`` on the CPU: every column done at entry (one
    launch, no input changed byte for byte, ``synd_hat`` the targets); B=1;
    B=1001 (a ragged last block); one column that runs all ``num_iter``
    iterations among 63 that converge at the first (one block's other
    columns idle meanwhile); and 3000 columns, 70 % done at entry (as in a
    GDG burst: blocks whose columns are all done leave at once, the others
    hold live columns beside done ones, each done one given its target
    syndrome)."""
    B = {"all_done": 200, "one_column": 1, "ragged": 1001, "one_slow": 64,
         "mostly_done": 3000}[case]
    H, prior, synds, err0, done0, kw = _bp_span_case(True, "float32", B, 31)
    if case == "all_done":
        done0 = torch.ones(B, dtype=torch.bool)
    elif case == "one_column":
        done0 = torch.zeros(1, dtype=torch.bool)
    elif case == "mostly_done":
        done0 = torch.as_tensor(np.random.default_rng(37).random(B) < 0.7)
    else:  # zero syndromes converge at once; one random syndrome never does
        kw = {k: v for k, v in kw.items() if k not in ("vn_state", "cn_state")}
        kw.update(masked=False)
        synds = torch.zeros_like(synds)
        synds[17] = torch.as_tensor(np.random.default_rng(31).integers(0, 2, synds.shape[1]),
                                    dtype=torch.uint8)
        err0 = torch.zeros_like(err0)
        done0 = torch.zeros(B, dtype=torch.bool)
    args_c, kw_c = _span_args(H, prior, synds, err0, done0, kw, "cpu", seed=31)
    args_k, kw_k = _span_args(H, prior, synds, err0, done0, kw, card, seed=31)
    kw_c["return_synd"] = kw_k["return_synd"] = True
    ref = _inplace_pair(card, args_c, kw_c, args_k, kw_k)
    if case == "all_done":
        assert torch.equal(ref[5], args_c[4].to(torch.int8) & 1)
    if case == "one_slow":
        it = ref[4]
        assert int(it[17]) == kw["num_iter"] and not bool(ref[3][17])
        assert bool((it[torch.arange(B) != 17] == 1).all())


def _window144(which: int):
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment

    return build_bb_window_experiment(144, 0.004, 12, 3, 1)[3].windows[which]


def _osd_case(card, spec, B, seed):
    """Packed PCM, syndromes, keys with exact ties and +-0.0, and the
    window's 1-D prior as LLRs, on the card."""
    from slidingwindowdecoder_torch.ops.gf2_solve import gf2_rank_packed, pack_rows_host

    H = spec.mat
    m, n = H.shape
    rng = np.random.default_rng(seed)
    key = (rng.integers(-16, 16, (B, n)) * 0.25).astype(np.float32)
    key[:, ::11] = -0.0
    key[:, 5::11] = 0.0
    p = np.asarray(spec.prior, np.float64)
    return dict(
        Hw=torch.as_tensor(pack_rows_host(H).view(np.int32), device=card),
        synd=torch.as_tensor(rng.random((B, m)) < 0.1, dtype=torch.uint8, device=card),
        key=torch.as_tensor(key, device=card),
        llr=torch.as_tensor(np.log((1 - p) / p).astype(np.float32), device=card),
        m=m, n=n, rank=gf2_rank_packed(H))


@pytest.mark.parametrize("which", [1, -1])
def test_gj_kernel_bit_exact_windows(card, which):
    """The redesigned elimination on the [[144]] window PCMs (216x1728 and
    the rank-deficient 216x1656) with tie keys: every output bit-exact."""
    from slidingwindowdecoder_torch.ops.gf2_cuda import gauss_jordan_key
    from slidingwindowdecoder_torch.ops.gf2_solve import ordered_gauss_jordan_key

    c = _osd_case(card, _window144(which), 64, 8)
    kw = dict(m=c["m"], n=c["n"], rank=c["rank"])
    before = gauss_jordan_key.launches
    out = gauss_jordan_key(c["Hw"], c["synd"], c["key"], **kw)
    assert gauss_jordan_key.launches == before + 1
    ref = ordered_gauss_jordan_key(c["Hw"], c["synd"], c["key"], **kw)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("B", [1, 37, 256])
@pytest.mark.parametrize("which", [1, -1])
def test_osd_cs_fused_bit_exact(card, which, B):
    """The fused launch against the plain elimination and sweep on the
    card: solution, OSD-0, inconsistency and the bits of min_pm equal."""
    from slidingwindowdecoder_torch.ops.gf2_cuda import osd_cs_fused
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        _osd_sweep_cs_sortless,
        analyze_patterns,
        ordered_gauss_jordan_key,
        osd_candidate_patterns,
    )

    c = _osd_case(card, _window144(which), B, 9 + B)
    m, n, rank = c["m"], c["n"], c["rank"]
    meta = analyze_patterns(osd_candidate_patterns(n - rank, 10, "osd_cs"), n - rank)
    pi, pj = (torch.as_tensor(meta[k], device=card) for k in ("pair_i", "pair_j"))
    before = osd_cs_fused.launches
    out = osd_cs_fused(c["Hw"], c["synd"], c["key"], c["llr"], pi, pj, m=m, n=n, rank=rank,
                       order_w=meta["order_w"])
    assert osd_cs_fused.launches == before + 1
    gj = ordered_gauss_jordan_key(c["Hw"], c["synd"], c["key"], m=m, n=n, rank=rank)
    sol, min_pm = _osd_sweep_cs_sortless(gj, c["key"], c["llr"], pi, pj,
                                         order_w=meta["order_w"])
    assert torch.equal(out["solution"], sol)
    assert torch.equal(out["osd0"], gj["osd0"])
    assert torch.equal(out["inconsistent"], gj["inconsistent"])
    assert torch.equal(out["min_pm"].view(torch.int32), min_pm.view(torch.int32))
    if B > 1:
        assert bool((out["solution"] != out["osd0"]).any())
    with pytest.raises(ValueError):  # the kernel takes a 1-D prior only
        osd_cs_fused(c["Hw"], c["synd"], c["key"], c["llr"].expand(B, n), pi, pj, m=m, n=n,
                     rank=rank, order_w=meta["order_w"])


def test_gj_smem_layout_matches_kernel(card):
    """The gate's shared-memory count (``smem_bytes``) equals the kernel's
    own layout (``gj_smem_bytes``) in both modes, at the window shapes and
    at shapes where the sort's pairs outgrow the state."""
    import ctypes

    from slidingwindowdecoder_torch.ops import gf2_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    fn = cuda_build.load(gf2_cuda.SOURCE).gj_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    for m, n in ((216, 1728), (216, 1656), (72, 468), (46, 150), (8, 1000), (512, 700)):
        W = -(-n // 32)
        for fused in (False, True):
            assert fn(m, n, W, int(fused)) == gf2_cuda.smem_bytes(m, n, W, fused)


def _wide_spec(which: str):
    """The shapes of the cluster route: an interior [[288]] W=4 window
    (576x4896) or the [[144]] global DEM (936x8784), with its prior."""
    from types import SimpleNamespace

    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment

    if which == "288w4":
        return build_bb_window_experiment(288, 0.005, 6, 4, 1)[3].windows[1]
    dem = build_bb_window_experiment(144, 0.004, 12, 3, 1)[2]
    return SimpleNamespace(mat=dem.chk, prior=dem.priors)


# (PCM, forced blocks per shot or None for the route's own choice, shots)
CLUSTER_CASES = [("window", 2, 8), ("window", 4, 8), ("window", 8, 8), ("last", 4, 8),
                 ("288w4", None, 4), ("global", None, 2)]


def _cluster_spec(which):
    return {"window": lambda: _window144(1), "last": lambda: _window144(-1)}.get(
        which, lambda: _wide_spec(which))()


@pytest.mark.parametrize("which, C, B", CLUSTER_CASES)
def test_gj_cluster_bit_exact(card, which, C, B):
    """The cluster route of the elimination, forced at the [[144]] window
    shapes with 2, 4 and 8 blocks and taken by the route at 576x4896 (C=2)
    and 936x8784 (C=8), on tie keys: every output equal to the plain
    version's on the card."""
    from slidingwindowdecoder_torch.ops.gf2_cuda import gauss_jordan_key
    from slidingwindowdecoder_torch.ops.gf2_solve import ordered_gauss_jordan_key

    c = _osd_case(card, _cluster_spec(which), B, 21 + B)
    kw = dict(m=c["m"], n=c["n"], rank=c["rank"])
    before = gauss_jordan_key.cluster_launches, gauss_jordan_key.launches
    out = gauss_jordan_key(c["Hw"], c["synd"], c["key"], **kw, cluster_blocks=C)
    assert (gauss_jordan_key.cluster_launches, gauss_jordan_key.launches) == (
        before[0] + 1, before[1])
    ref = ordered_gauss_jordan_key(c["Hw"], c["synd"], c["key"], **kw)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("which, C, B", CLUSTER_CASES)
def test_osd_cs_fused_cluster_bit_exact(card, which, C, B):
    """The cluster route of the fused OSD-CS launch against the plain
    elimination and sweep on the card: solution, OSD-0, inconsistency and
    the bits of min_pm equal (the sums passed from block to block keep the
    single block's orders)."""
    from slidingwindowdecoder_torch.ops.gf2_cuda import osd_cs_fused
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        _osd_sweep_cs_sortless,
        analyze_patterns,
        ordered_gauss_jordan_key,
        osd_candidate_patterns,
    )

    c = _osd_case(card, _cluster_spec(which), B, 31 + B)
    m, n, rank = c["m"], c["n"], c["rank"]
    meta = analyze_patterns(osd_candidate_patterns(n - rank, 10, "osd_cs"), n - rank)
    pi, pj = (torch.as_tensor(meta[k], device=card) for k in ("pair_i", "pair_j"))
    before = osd_cs_fused.cluster_launches, osd_cs_fused.launches
    out = osd_cs_fused(c["Hw"], c["synd"], c["key"], c["llr"], pi, pj, m=m, n=n, rank=rank,
                       order_w=meta["order_w"], cluster_blocks=C)
    assert (osd_cs_fused.cluster_launches, osd_cs_fused.launches) == (before[0] + 1,
                                                                      before[1])
    gj = ordered_gauss_jordan_key(c["Hw"], c["synd"], c["key"], m=m, n=n, rank=rank)
    sol, min_pm = _osd_sweep_cs_sortless(gj, c["key"], c["llr"], pi, pj,
                                         order_w=meta["order_w"])
    assert torch.equal(out["solution"], sol)
    assert torch.equal(out["osd0"], gj["osd0"])
    assert torch.equal(out["inconsistent"], gj["inconsistent"])
    assert torch.equal(out["min_pm"].view(torch.int32), min_pm.view(torch.int32))


def test_gj_cluster_layout_matches_kernel(card):
    """The cluster gate's shared-memory count equals the kernel's own
    layout (that the route's clusters fit the card, the launch checks with
    ``cudaOccupancyMaxActiveClusters``: the bit-exact cases above launch
    at 576x4896 and 936x8784)."""
    import ctypes

    from slidingwindowdecoder_torch.ops import gf2_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    fn = cuda_build.load(gf2_cuda.SOURCE).gj_cluster_smem_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    for m, n in ((576, 4752), (576, 4896), (936, 8784), (216, 1728), (10, 300)):
        W = -(-n // 32)
        for C in gf2_cuda.CLUSTER_SIZES:
            for fused in (False, True):
                assert fn(m, n, W, C, int(fused)) == gf2_cuda.cluster_smem_bytes(
                    m, n, W, C, fused)


def _cc_inputs(p, shots, seed):
    from slidingwindowdecoder_torch.codes import bb_code_by_n

    code, _, _ = bb_code_by_n(72)
    rng = np.random.default_rng(seed)
    probs = p * (0.75 + 0.5 * rng.random(code.N))
    errs = (rng.random((shots, code.N)) < probs).astype(np.uint8)
    return code, probs, (errs @ code.hx.T) % 2


def _launches():
    """Launch counts, and ``vn_set_values``' torch ops on the card (which
    every decimating path now leaves to the decide-and-peel kernel)."""
    from slidingwindowdecoder_torch.ops import bp_cuda, decimation, gf2_cuda

    span, cn = bp_cuda.bp_span, bp_cuda.cn_update
    return {"bp_span": span.launches, "bp_span_pinned": span.pinned_launches,
            "cn_update": cn.launches + cn.pinned_launches,
            "gauss_jordan_key": gf2_cuda.gauss_jordan_key.launches,
            "osd_cs_fused": gf2_cuda.osd_cs_fused.launches,
            "cluster": gf2_cuda.gauss_jordan_key.cluster_launches
            + gf2_cuda.osd_cs_fused.cluster_launches,
            "vn_set_values": decimation.vn_set_values.card_calls}


@pytest.mark.parametrize("mode", ["loop", "spans"])
def test_bpgd_card_matches_cpu(card, mode):
    """BPGD with the ``Misc.ipynb`` cell 10 knobs (no pre-BP, 12 masked
    iterations a step at ``gd_factor`` 0.8) on bb72 syndromes: every burst
    is one pinned fused launch and the decode equals the plain one on the
    CPU, shot for shot."""
    from slidingwindowdecoder_torch.decoders import BPGD

    code, probs, synds = _cc_inputs(0.1, 128, 9)
    kw = dict(max_iter=0, max_iter_per_step=12, gd_factor=0.8, max_step=code.N,
              new_n=code.N, bucket=64, row_bucket=64, mode=mode)
    before = _launches()
    rc = BPGD(code.hx, probs, device=card, **kw).decode_batch(synds)
    ran = {k: v - before[k] for k, v in _launches().items()}
    assert ran["bp_span_pinned"] > 0 and not any(v for k, v in ran.items()
                                                 if k != "bp_span_pinned")
    rp = BPGD(code.hx, probs, device="cpu", **kw).decode_batch(synds)
    for k in ("error", "converged", "iterations", "min_pm"):
        np.testing.assert_array_equal(getattr(rc, k), getattr(rp, k), err_msg=k)


def test_gdg_spans_card_matches_cpu(card):
    """GDG's spans form at the code-capacity factor 0.625 with
    ``low_error_mode`` on bb72 syndromes, 88-column row buckets: the card's
    decode (pre-BP on the unmasked fused kernel, bursts on the pinned one)
    equals the plain one on the CPU, shot for shot."""
    from slidingwindowdecoder_torch.decoders import GDG

    code, probs, synds = _cc_inputs(0.13, 64, 7)
    kw = dict(max_iter=24, ms_scaling_factor=0.625, gdg_factor=0.625, max_iter_per_step=6,
              max_step=40, max_tree_depth=3, max_side_depth=10, max_tree_branch_step=20,
              max_side_branch_step=20, low_error_mode=True, ensemble_bucket=16,
              ensemble_mode="spans", row_bucket=128)
    before = _launches()
    rc = GDG(code.hx, probs, device=card, **kw).decode_batch(synds)
    ran = {k: v - before[k] for k, v in _launches().items()}
    assert ran["bp_span"] == 1 and ran["bp_span_pinned"] > 0
    assert not (ran["cn_update"] or ran["gauss_jordan_key"] or ran["osd_cs_fused"]
                or ran["vn_set_values"])
    rp = GDG(code.hx, probs, device="cpu", **kw).decode_batch(synds)
    for k in ("error", "converged", "iterations", "min_pm"):
        np.testing.assert_array_equal(getattr(rc, k), getattr(rp, k), err_msg=k)


def test_gdg_serial_card_matches_cpu(card):
    """The serial work queue (``multi_thread=False``) with bf16 messages on
    bb72 syndromes: every step's BP is one pinned fused launch, the pre-BP
    one unmasked launch, and the card's decode equals the plain one on the
    CPU, shot for shot."""
    from slidingwindowdecoder_torch.decoders import GDG

    code, probs, synds = _cc_inputs(0.13, 64, 7)
    kw = dict(max_iter=24, max_iter_per_step=6, max_step=40, max_tree_depth=3,
              max_side_depth=10, max_tree_branch_step=20, max_side_branch_step=20,
              multi_thread=False, ensemble_bucket=16, msg_dtype="bfloat16")
    before = _launches()
    rc = GDG(code.hx, probs, device=card, **kw).decode_batch(synds)
    ran = {k: v - before[k] for k, v in _launches().items()}
    assert ran["bp_span"] == 1 and ran["bp_span_pinned"] > 0
    assert not (ran["cn_update"] or ran["gauss_jordan_key"] or ran["osd_cs_fused"]
                or ran["vn_set_values"])
    rp = GDG(code.hx, probs, device="cpu", **kw).decode_batch(synds)
    assert (rp.iterations > kw["max_iter"]).sum() >= 16
    for k in ("error", "converged", "iterations", "min_pm"):
        np.testing.assert_array_equal(getattr(rc, k), getattr(rp, k), err_msg=k)


def _bp4_call(code_name, shots, seed, *, random_synd=False):
    """The ``bp4_run`` arguments of one BP4 decode on the card by a
    depolarizing row's decoder (``bp4_row_call`` of
    ``tools/torch_validate_depolarizing.py``): ``BP4OSD.core`` on [[882]]
    (the bp4 rows: p = 0.1, 100 iterations at min-sum 0.625) or
    ``camel_core`` on [[362]] (p = 0.02, 50 iterations at 0.8: 4 branch
    lanes a shot, the last variable decided to each Pauli and its checks'
    parities flipped), on depolarizing syndromes from ``seed`` or, with
    ``random_synd``, uniformly random ones that BP4 converges on none of."""
    tools = str(Path(__file__).resolve().parents[1] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    from torch_validate_depolarizing import bp4_row_call

    return bp4_row_call("bp4_osdcs" if code_name == "882" else "camel", shots, seed,
                        random_synd=random_synd)


def _bp4_span_matches_plain(args, kw):
    """``bp4_run`` on the card (one ``bp4_span`` launch) against the plain
    loop on the card: all nine outputs bit-equal. Returns the outputs."""
    from slidingwindowdecoder_torch.ops.bp4 import bp4_loop, bp4_run
    from slidingwindowdecoder_torch.ops.bp4_cuda import bp4_span

    before = bp4_span.launches, bp4_span.plain_calls
    out = bp4_run(*args, **kw)
    assert (bp4_span.launches, bp4_span.plain_calls) == (before[0] + 1, before[1])
    ref = bp4_loop(*args, **kw)
    names = ("mvx", "mvz", "lprx", "lpry", "lprz", "ex", "ez", "done", "iters")
    for name, a, b in zip(names, out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name
    return out


@pytest.mark.parametrize("code_name, shots", [("882", 2048), ("362", 1024), ("882", 2047)],
                         ids=["882-2048", "362-camel-4096", "882-2047"])
def test_bp4_span_matches_plain_loop(card, code_name, shots):
    """The bp4 rows' [[882]] batch (2048 shots, and 2047) and CAMEL's 4096
    [[362]] branch lanes: the fused kernel bit-exact against the plain loop
    on the card; some shots converge and some run to ``num_iter``."""
    args, kw = _bp4_call(code_name, shots, 5)
    out = _bp4_span_matches_plain(args, kw)
    done, iters = out[7], out[8]
    assert 0 < int(done.sum()) < done.numel()
    assert int((iters == kw["num_iter"]).sum()) > 0


def test_bp4_span_done_at_entry_and_never_converging(card):
    """Shots done at entry keep their incoming messages, zero posteriors and
    errors and their counts; on random syndromes no shot converges and every
    other shot runs all ``num_iter`` iterations: bit-exact against the plain
    loop on the card."""
    args, kw = _bp4_call("882", 2048, 9, random_synd=True)
    B = args[7].shape[0]
    done = torch.zeros(B, dtype=torch.bool, device="cuda")
    done[::7] = True
    args[12] = done
    args[13] = torch.arange(B, dtype=torch.int32, device="cuda") % 5
    kw = {**kw, "num_iter": 30}
    out = _bp4_span_matches_plain(args, kw)
    assert torch.equal(out[7], done)
    assert torch.equal(out[8], args[13] + torch.where(done, 0, 30).int())
    assert not out[2][done].any() and not out[5][done].any()


def test_bp4_span_smem_layout_matches_kernel(card):
    """The gate's shared-memory count (``bp4_span_smem_bytes``) equals the
    kernel's own layout on [[882]] and [[362]]."""
    import ctypes

    from slidingwindowdecoder_torch.codes import (
        create_cycle_assemble_codes,
        create_cyclic_permuting_matrix,
        create_QC_GHP_codes,
    )
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops import bp4_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    fn = cuda_build.load(bp4_cuda.SOURCE).bp4_span_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    codes = (create_QC_GHP_codes(63, create_cyclic_permuting_matrix(7, [27, 54, 0]), [0, 1, 6]),
             create_cycle_assemble_codes(19, 3))
    for code in codes:
        gx, gz = (graph_tensors(compile_graph(H), "cpu") for H in (code.hx, code.hz))
        nnz = sum(bp4_cuda.bp4_span_tables(g)["nnz"] for g in (gx, gz))
        assert fn(gx["n"], gx["m"] + gz["m"], nnz) == bp4_cuda.bp4_span_smem_bytes(gx, gz)


def _peel_states(rng, H, B, transposed, dev):
    """Random decisions (60 % of the VNs, random values; every fourth
    column decides none) from a random syndrome, a fifth of the columns
    dead at entry, on ``dev``: (garr, state)."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops import decimation as dec

    garr = graph_tensors(compile_graph(H), dev)
    m, n = H.shape
    synd = torch.as_tensor(rng.integers(0, 2, (B, m)).astype(np.uint8), device=dev)
    mask = rng.random((B, n)) < 0.6
    mask[::4] = False
    mask = torch.as_tensor(mask, device=dev)
    vals = torch.as_tensor(rng.integers(0, 2, (B, n)).astype(np.int8), device=dev)
    dead = torch.as_tensor(rng.random(B) < 0.2, device=dev)
    if transposed:
        st = dec.init_decimation_state_t(garr, synd.T.contiguous())
        return garr, dec.vn_set_values_t(garr, *st[:3], dead, mask.T.contiguous(),
                                         vals.T.contiguous())
    st = dec.init_decimation_state(garr, synd)
    return garr, dec.vn_set_values(garr, *st[:3], dead, mask, vals)


@pytest.mark.parametrize("max_sweeps", [None, 1, 3])
@pytest.mark.parametrize("transposed", [False, True], ids=["peel", "peel_t"])
def test_peel_kernel_matches_plain_loop(card, transposed, max_sweeps):
    """``csrc/peel.cu`` against the plain loop on the same states on the
    card, bit for bit, on a [[72]] window PCM with 301 columns (not a
    multiple of a block's columns) and dead columns at entry; one launch a
    call, and its device counters add the batch's sweeps."""
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.ops import decimation as dec
    from slidingwindowdecoder_torch.ops import peel_cuda

    _, _, _, plan = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    rng = np.random.default_rng(17)
    garr, st = _peel_states(rng, plan.windows[0].mat, 301, transposed, card)
    stats0 = peel_cuda.sweep_stats(card).clone()
    before = peel_cuda.peel_fixpoint.launches
    out = (dec.peel_t if transposed else dec.peel)(garr, *st, max_sweeps=max_sweeps)
    assert peel_cuda.peel_fixpoint.launches == before + 1
    sweeps = int(peel_cuda.sweep_stats(card)[0] - stats0[0])
    ref = dec._peel_loop(garr, *st, max_sweeps, transposed=transposed)
    for name, a, b in zip(("vn", "cn", "deg", "dead"), out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert 1 <= sweeps <= (max_sweeps or 10**9)
    assert (out[0] != -1).sum() > (st[0] != -1).sum() and out[3].any()


@pytest.mark.parametrize("transposed", [False, True], ids=["peel", "peel_t"])
def test_peel_kernel_stops_with_the_last_live_row(card, transposed):
    """Two copies of a path graph of 16 VNs, a live column forced from both
    ends and a dead one from one end: the kernel stops the dead column at
    the live column's last sweep, as the plain loop does (8 sweeps)."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops import decimation as dec
    from slidingwindowdecoder_torch.ops import peel_cuda

    n = 16
    H = np.zeros((n - 1, n), np.uint8)
    for i in range(n - 1):
        H[i, i] = H[i, i + 1] = 1
    garr = graph_tensors(compile_graph(H), card)
    mask = torch.zeros((2, n), dtype=torch.bool, device=card)
    mask[1, [0, n - 1]] = True
    mask[0, 0] = True
    dead = torch.tensor([True, False], device=card)
    synd = torch.zeros((2, n - 1), dtype=torch.uint8, device=card)
    zeros = torch.zeros((2, n), dtype=torch.int8, device=card)
    if transposed:
        st = dec.init_decimation_state_t(garr, synd.T.contiguous())
        st = dec.vn_set_values_t(garr, *st[:3], dead, mask.T.contiguous(), zeros.T.contiguous())
    else:
        st = dec.init_decimation_state(garr, synd)
        st = dec.vn_set_values(garr, *st[:3], dead, mask, zeros)
    s0 = int(peel_cuda.sweep_stats(card)[0])
    out = (dec.peel_t if transposed else dec.peel)(garr, *st)
    assert int(peel_cuda.sweep_stats(card)[0]) - s0 == 8
    ref = dec._peel_loop(garr, *st, transposed=transposed)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    vn = (out[0].T if transposed else out[0]).cpu().numpy()
    np.testing.assert_array_equal(vn[0], [0] * 9 + [-1] * 7)


def test_gdg_fused_card_matches_cpu_without_a_sync(card):
    """GDG's fused ensemble (``gdg_ensemble``, fixed trips) on bb72
    syndromes: no host read from each bucket's first step through its
    reduce (under ``torch.cuda.set_sync_debug_mode("error")``), every step
    of every bucket run, peels on the kernel, and the card's decode equals
    the plain one on the CPU, shot for shot."""
    from slidingwindowdecoder_torch.decoders import GDG
    from slidingwindowdecoder_torch.decoders import gdg as gdg_mod
    from slidingwindowdecoder_torch.ops import peel_cuda

    code, probs, synds = _cc_inputs(0.13, 64, 7)
    kw = dict(max_iter=24, max_iter_per_step=6, max_step=40, max_tree_depth=3,
              max_side_depth=10, max_tree_branch_step=20, max_side_branch_step=20,
              ensemble_bucket=16, ensemble_mode="fused")
    step, reduce = gdg_mod._ensemble_step, gdg_mod._ensemble_reduce
    seen = {"steps": 0, "reduces": 0}

    def watched_step(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        seen["steps"] += 1
        return step(*a, **k)

    def watched_reduce(*a, **k):
        out = reduce(*a, **k)
        torch.cuda.set_sync_debug_mode("default")
        seen["reduces"] += 1
        return out

    dec_card = GDG(code.hx, probs, device=card, **kw)
    before = peel_cuda.peel_fixpoint.launches
    gdg_mod._ensemble_step, gdg_mod._ensemble_reduce = watched_step, watched_reduce
    try:
        rc = dec_card.decode_batch(synds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        gdg_mod._ensemble_step, gdg_mod._ensemble_reduce = step, reduce
    assert seen["reduces"] > 0 and seen["steps"] == seen["reduces"] * dec_card.D_max
    assert peel_cuda.peel_fixpoint.launches > before
    rp = GDG(code.hx, probs, device="cpu", **kw).decode_batch(synds)
    for k in ("error", "converged", "iterations", "min_pm"):
        np.testing.assert_array_equal(getattr(rc, k), getattr(rp, k), err_msg=k)


def _decide_case(rng, H, B, transposed, dev, form):
    """(garr, state, decision) on ``dev``: a state in mid-decimation (the
    ``_peel_states`` kind, a third of the VNs decided, a fifth of the
    columns dead) and a decision of ``form``: "mask" (half the VNs, decided
    ones included, random values: conflicts and contradictions), "zeros"
    (the mask with values None) or "index" (one VN a column, decided or
    not, some out of range, do-set off on some)."""
    garr, st = _peel_states(rng, H, B, transposed, dev)
    m, n = H.shape
    vn = st[0].T if transposed else st[0]
    if form == "index":
        index = torch.as_tensor(rng.integers(0, n + 2, B), device=dev)
        value = torch.as_tensor(rng.integers(0, 2, B).astype(np.int8), device=dev)
        do_set = torch.as_tensor(rng.random(B) < 0.8, device=dev)
        return garr, st, dict(index=index, value=value, do_set=do_set)
    mask = torch.as_tensor(rng.random(tuple(vn.shape)) < 0.5, device=dev)
    vals = torch.as_tensor(rng.integers(0, 2, tuple(vn.shape)).astype(np.int8), device=dev)
    if transposed:
        mask, vals = mask.T.contiguous(), vals.T.contiguous()
    return garr, st, dict(set_mask=mask, values=None if form == "zeros" else vals)


def _decide_plain(garr, st, transposed, max_sweeps, decision):
    """The plain pair on the same device: ``vn_set_values(_t)`` of the
    decision, then the plain peel loop."""
    from slidingwindowdecoder_torch.ops import decimation as dec

    st = dec._plain_decision(garr, st, transposed, **decision)
    return dec._peel_loop(garr, *st, max_sweeps, transposed=transposed)


@pytest.mark.parametrize("B", [301, 320])
@pytest.mark.parametrize("max_sweeps", [None, 2])
@pytest.mark.parametrize("form", ["mask", "zeros", "index"])
@pytest.mark.parametrize("transposed", [False, True], ids=["batch_major", "transposed"])
def test_decide_and_peel_kernel_matches_plain(card, transposed, form, max_sweeps, B):
    """``csrc/peel.cu``'s decide-and-peel launch against the plain pair on
    the same inputs on the card, bit for bit, in both layouts and both
    decision forms, on a [[72]] window PCM with 301 columns (not a
    multiple of a block's columns, nor of 4: the transposed tile's
    byte-wise loads) and 320 (its 4-column word loads): one launch a
    call, with a decision, and no torch op of ``vn_set_values`` on the
    card."""
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.ops import decimation as dec
    from slidingwindowdecoder_torch.ops import peel_cuda

    _, _, _, plan = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    rng = np.random.default_rng(23)
    garr, st, decision = _decide_case(rng, plan.windows[0].mat, B, transposed, card, form)
    fn = {(False, True): dec.set_values_and_peel, (True, True): dec.set_values_and_peel_t,
          (False, False): dec.set_index_and_peel, (True, False): dec.set_index_and_peel_t}[
        transposed, form != "index"]
    fp = peel_cuda.peel_fixpoint
    before = fp.launches, fp.decide_launches, fp.plain_calls, dec.vn_set_values.card_calls
    out = fn(garr, *st, **decision, max_sweeps=max_sweeps)
    assert (fp.launches, fp.decide_launches, fp.plain_calls,
            dec.vn_set_values.card_calls) == (before[0] + 1, before[1] + 1, *before[2:])
    ref = _decide_plain(garr, st, transposed, max_sweeps, decision)
    for name, a, b in zip(("vn", "cn", "deg", "dead"), out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert out[3].sum() > st[3].sum()


@pytest.mark.parametrize("transposed", [False, True], ids=["batch_major", "transposed"])
def test_decide_and_peel_carries_paused_columns(card, transposed):
    """The one-launch stop rule: 4096 copies of a path graph of 64 VNs,
    the decision in the launch. One live column is decided at both ends
    (31 forcing sweeps); every other column is dead and decided at one end,
    so it pauses after its first sweep and the grid's warps must carry it
    on to the live column's last sweep (32 in all) after the barrier; as
    the plain pair does, and twice in a row (the scratch is left zeroed)."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops import decimation as dec
    from slidingwindowdecoder_torch.ops import peel_cuda

    n, B = 64, 4096
    H = np.zeros((n - 1, n), np.uint8)
    H[np.arange(n - 1), np.arange(n - 1)] = H[np.arange(n - 1), np.arange(1, n)] = 1
    garr = graph_tensors(compile_graph(H), card)
    mask = torch.zeros((B, n), dtype=torch.bool, device=card)
    mask[:, 0] = True
    mask[B // 2, n - 1] = True
    dead = torch.ones(B, dtype=torch.bool, device=card)
    dead[B // 2] = False
    synd = torch.zeros((B, n - 1), dtype=torch.uint8, device=card)
    if transposed:
        st = (*dec.init_decimation_state_t(garr, synd.T.contiguous())[:3], dead)
        fn, mask = dec.set_values_and_peel_t, mask.T.contiguous()
    else:
        st = (*dec.init_decimation_state(garr, synd)[:3], dead)
        fn = dec.set_values_and_peel
    ref = _decide_plain(garr, st, transposed, None, dict(set_mask=mask))
    for _ in range(2):
        s0 = peel_cuda.sweep_stats(card).clone()
        out = fn(garr, *st, mask)
        sweeps, column_sweeps = (peel_cuda.sweep_stats(card) - s0).tolist()
        assert sweeps == 32 and column_sweeps == 32 * B
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
    vn = (out[0].T if transposed else out[0]).cpu().numpy()
    np.testing.assert_array_equal(vn[0], [0] * 33 + [-1] * 31)
    assert (vn[B // 2] == 0).all()


def test_decide_and_peel_empty_batch(card):
    """B = 0: empty outputs of the right shapes and dtypes, no launch."""
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.ops import decimation as dec
    from slidingwindowdecoder_torch.ops import peel_cuda

    _, _, _, plan = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    garr, st = _peel_states(np.random.default_rng(3), plan.windows[0].mat, 0, True, card)
    before = peel_cuda.peel_fixpoint.launches
    z = torch.zeros(0, dtype=torch.int64, device=card)
    out = dec.set_index_and_peel_t(garr, *st, z, z.to(torch.int8), z.bool())
    assert peel_cuda.peel_fixpoint.launches == before
    for a, b in zip(out, st):
        assert a.shape == b.shape and a.dtype == b.dtype and a.device == b.device


def test_decide_and_peel_refuses_cpu_and_oversized_graphs(card):
    """The wrapper launches the kernel or raises: on CPU tensors, and on a
    graph one column of whose state exceeds shared memory."""
    from slidingwindowdecoder_torch.ops import peel_cuda

    def state(n, m, B, dev):
        return (torch.full((B, n), -1, dtype=torch.int8, device=dev),
                torch.zeros((B, m), dtype=torch.int8, device=dev),
                torch.zeros((B, m), dtype=torch.int32, device=dev),
                torch.zeros(B, dtype=torch.bool, device=dev))

    garr = {"n": 6, "m": 3, "m_pad": 8, "dc": 2, "dv": 1}
    with pytest.raises(ValueError, match="unsupported device"):
        peel_cuda.peel_fixpoint(garr, *state(6, 3, 4, "cpu"), transposed=False)
    big = {"n": 100_000, "m": 50_000, "m_pad": 50_008, "dc": 4, "dv": 2}
    with pytest.raises(ValueError, match="exceeds shared memory"):
        peel_cuda.peel_fixpoint(big, *state(100_000, 50_000, 2, card), transposed=False,
                                set_mask=torch.zeros((2, 100_000), dtype=torch.bool,
                                                     device=card))


def test_peel_smem_layout_matches_kernel(card):
    """The wrapper's shared-memory size of a column equals the kernel's
    ``make_layout``, at the paths' shapes and odd ones."""
    import ctypes

    from slidingwindowdecoder_torch.ops import peel_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    lib = cuda_build.load(peel_cuda.SOURCE)
    fn = lib.peel_smem_per_column
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    for n, rows in ((1656, 224), (1728, 224), (882, 441), (4896, 608), (64, 63), (7, 3)):
        assert fn(n, rows) == peel_cuda.smem_per_column(n, rows)
