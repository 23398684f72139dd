"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA card (Hopper, ``sm_90a``) and ``nvcc``; they skip
without one. Run them there with
``python -m pytest tests/test_torch_cuda.py -q``.
"""

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


def _bp_span_case(masked, dtype, B, seed):
    """bp_run inputs on the [[72]] x3 W=2 window graph (72x468 in the first
    window), with real-looking syndromes and, masked, a peeled decimation
    state that decides about a third of the VNs."""
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.ops import decimation

    _, _, _, plan = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    H = plan.windows[1].mat
    rng = np.random.default_rng(seed)
    n = H.shape[1]
    p = np.asarray(plan.windows[1].prior, np.float64)
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
    flagship [[144]] window graphs, at every block size the gate allows."""
    import ctypes

    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    fn = cuda_build.load(bp_cuda.SPAN_SOURCE).bp_span_smem_bytes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    for code, p, rounds, w in ((72, 0.01, 3, 2), (144, 0.004, 12, 3)):
        H = build_bb_window_experiment(code, p, rounds, w, 1)[3].windows[1].mat
        garr = graph_tensors(compile_graph(H), "cpu")
        shots = bp_cuda.max_shots_per_block(garr, dtype)
        assert shots >= 1
        for s in range(1, shots + 1):
            assert fn(dtype.itemsize, garr["n"], garr["m_pad"], garr["dc"], garr["dv"],
                      s) == bp_cuda.span_smem_bytes(garr, dtype, s)


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


def _cc_inputs(p, shots, seed):
    from slidingwindowdecoder_torch.codes import bb_code_by_n

    code, _, _ = bb_code_by_n(72)
    rng = np.random.default_rng(seed)
    probs = p * (0.75 + 0.5 * rng.random(code.N))
    errs = (rng.random((shots, code.N)) < probs).astype(np.uint8)
    return code, probs, (errs @ code.hx.T) % 2


def _launches():
    from slidingwindowdecoder_torch.ops import bp_cuda, gf2_cuda

    span, cn = bp_cuda.bp_span, bp_cuda.cn_update
    return {"bp_span": span.launches, "bp_span_pinned": span.pinned_launches,
            "cn_update": cn.launches + cn.pinned_launches,
            "gauss_jordan_key": gf2_cuda.gauss_jordan_key.launches,
            "osd_cs_fused": gf2_cuda.osd_cs_fused.launches}


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
    assert not (ran["cn_update"] or ran["gauss_jordan_key"] or ran["osd_cs_fused"])
    rp = GDG(code.hx, probs, device="cpu", **kw).decode_batch(synds)
    for k in ("error", "converged", "iterations", "min_pm"):
        np.testing.assert_array_equal(getattr(rc, k), getattr(rp, k), err_msg=k)
