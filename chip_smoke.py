#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU).

Run from the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. build the three hand-written kernel sources from
   ``slidingwindowdecoder_torch/csrc`` (one ``nvcc`` each, started
   together);
2. kernel A (min-sum check-node update) against its plain PyTorch version
   at the flagship window shape [35, 224, B], B in {1024, 16384}, f32 and
   bf16, with forced ties, clipping and padding: bit-exact;
3. the pinned kernel A (masked BP) against its plain version at [35, 224,
   B], B in {512, 16384}, on a [[288]] W=4 window (m_pad 608) and on the
   [[144]] global DEM graph (m_pad 960) at B=1024, f32 and bf16, with ~30 %
   of the edges and whole checks pinned: bit-exact (kernel A now serves
   only the graphs outside the fused kernel's gate);
4. kernel B's elimination entry point (``gauss_jordan_key``: the
   reliability-ordered GF(2) Gauss-Jordan) against its plain version on a
   216x1728 and the rank-deficient 216x1656 window PCM at B=256, with keys
   that hold exact ties and +-0.0: every output bit-exact;
4b. kernel B's fused entry point (``osd_cs_fused``: the elimination and the
   OSD-CS sweep in one launch) against the plain elimination and sweep on
   the card: on the same tie keys at 216x1728 and 216x1656, and on the
   first OSD bucket of window 0 of each path (the real syndromes and BP
   reliabilities of the seed-2024 samples); solution, OSD-0, inconsistency
   and the bits of min_pm equal, with its time beside the standalone
   elimination's, kernel B's time before the fused design and the bound;
5. the fused BP kernel (``bp_span.cu``: a whole ``bp_run`` call in one
   launch) on the card against the plain loop on the CPU at every shape
   the paths give it, on window-0 syndromes of the seed-2024 samples: the
   whole-batch pre-BP (masked f32, B=16384, 8 iterations) and phase A
   (unmasked bf16, B=16384, 16 iterations), held on their first 512
   shots; a post-BP bucket (masked f32, B=512, shortened as ``OSDWindow``
   does, 200 iterations) and a phase-B bucket (unmasked bf16, B=1024, a
   48-iteration span), both with tail history; error, done, iterations
   and history bit-exact, and the messages of every shot not done; then
   the two buckets' times beside the per-op loop's on the card, and with
   the history ring written from the first iteration or never;
6. the main path: the [[144,12,12]] BB code, 12 rounds, p=0.004, (W,F) =
   (3,1) sliding-window BP+OSD-CS-10 with the bench knobs and bf16
   messages over 16384 shots drawn from seed 2024, with the launch counts
   of the kernels read around it (``bp_span`` and ``osd_cs_fused`` only)
   and the failure count held to exactly the JAX package's 414/16384 (and
   to 3 sigma of its rate); then a small input decoded on the card and by
   the plain versions on the CPU (no shot may differ);
7. the shortened path: the same experiment and samples decoded window by
   window with ``OSDWindow`` (pre-BP 8, post-BP 200, OSD-CS-10, f32), the
   decoder of ``sliding_window_decoder(shorten=True)``, with the launch
   counts read around it (``bp_span_pinned`` and ``osd_cs_fused`` only)
   and the failure count held to exactly the port's 309/16384 (and to 3
   sigma of the reference's 183/10000); then the first
   512 of those shots, at full width (no shot may differ), and a small
   input, each on the card and by the plain versions on the CPU;
8. the GDG path, the decoder of ``sliding_window_gdg`` (the reference's
   guessing.py: GDG with pre-BP 8 and the reference's ensemble defaults,
   22 branches, 25 steps, f32): first the ensemble's BP burst
   (``bp_span_pinned`` at B = bucket x 22, 6 masked iterations, tail
   history, the transposed state, ``synd_hat``), taken from a real bucket
   of window 0 entering the step after the first message reinit, on the
   card against the plain loop on the CPU, bit-exact, with its time beside
   the bound and the call's layout conversions; then the [[144,12,12]]
   experiment at p=0.005 over 8192 shots from seed 2024, with the launch
   counts read around it (``bp_span`` for the pre-BP and
   ``bp_span_pinned`` for the bursts only) and the failure count held to
   exactly the port's own ``GDG_FAILED`` (and to 3 sigma of the
   reference's 400/5000); then its first 64 shots at full width, and the
   small input, each on the card and by the plain versions on the CPU (no
   shot may differ);
9. ``[gdg_spans]``: the GDG path again with the span-compacted ensemble
   (``ensemble_mode="spans"``): exactly ``GDG_FAILED`` failures, and every
   correction and flag equal to the host-stepped form's, with its shots/s
   beside that form's and the columns stepped in each span as a share of
   the ensemble's columns;
10. code capacity on the [[882,24]] QC-GHP code (``Misc.ipynb`` cell 10)
   at p=0.04, 65536 shots from seed 2024: first kernel B at 441x882 on
   the first OSD bucket of the BP+OSD-0 and BP+OSD-CS-10 decodes of the
   first 8192 shots (``gauss_jordan_key`` and ``osd_cs_fused`` against
   their plain versions, bit-exact, with times and bounds); then
   ``[bp_span]`` on the BPGD
   burst at its real shape (a 2048-row bucket, 12 masked f32 iterations,
   slot-major carry, batch-major states), captured from the BPGD decode,
   on the card against the plain loop on the CPU, bit-exact, with its time
   beside the bound; then ``[cc_bpgd]`` (BPGD, no pre-BP, max_step 100,
   spans mode) and ``[cc_osd]`` (BP+OSD-0 and BP+OSD-CS-10 at min-sum
   0.625) through ``data_qubit_noise_decoding``, each held to its own
   count ``CC_FAILED`` and within 3 sigma of the reference's rate, with
   the launch counts read around it (``bp_span_pinned`` for BPGD;
   ``bp_span`` with ``gauss_jordan_key`` or ``osd_cs_fused`` for OSD);
   ``[cc_device]``: ``run_cc_campaign_device`` for BPGD over all VNs on
   [[882]] and GDG's spans form on [[288,12,18]] at p=0.02, 65536 shots
   each, within 3 sigma of the reference; ``[cc_slice]``: the first 256
   [[882]] shots by BPGD and GDG's spans form on the card and by the plain
   versions on the CPU, and by BPGD's two forms on the card, no shot
   differing;
11. a ``{"kernels": [...]}`` line, the card's name and power limit, and the
   final ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM arithmetic rates outside the tensor cores: 132 SMs at 1.98 GHz,
# times the results per clock per SM of compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput): 128 for float32
# add, multiply and compare (the published 67 TFLOP/s counts an FMA as
# two), 64 for 32-bit integer add, compare, shift and logic, 64 for
# float64 add
FP32_OPS_PER_S = 132 * 128 * 1.98e9
INT32_OPS_PER_S = FP64_ADDS_PER_S = 132 * 64 * 1.98e9
REF_FAILED, REF_SHOTS, SEED = 414, 16384, 2024  # the JAX package's flagship count
# the shortened osd_window decode: the reference's own rate (docs/PARITY.md,
# 183/10000 at p=0.004, W=3, 12 rounds), and the port's own count at seed
# 2024, which the per-op loop gave before the fused kernel (the kernel is
# bit-exact, so the count must not move)
REF_SHORT_FAILED, REF_SHORT_SHOTS = 183, 10000
SHORT_FAILED = 309
# operations of one fused BP iteration, counted from csrc/bp_span.cu: per
# valid edge the CN stage's two passes (clip 2, abs and cap 2, min update
# 3, sign count 2; clip 2, abs and cap 2, select 2, sign 2, negate 1,
# scale 1), the VN sum's add and the edge stage (subtract 1, pin test 2,
# sign count 2); per VN the prior add, the rounding and the pin select
SPAN_OPS_PER_EDGE, SPAN_OPS_PER_VN = 25, 3
# the first shots of the same samples, decoded on the shortened path on the
# card and by the plain versions on the CPU at full width
SLICE_SHOTS = 512
# the GDG path: [[144]] W=3 at p=0.005 (docs/PARITY.md, "[[144]] SW GDG
# W=3, p=0.005, pre-BP 8": the reference's 400/5000), 8192 shots; the
# port's own count at seed 2024 (its first run on the card, PERF.md); the
# ensemble bucket in shots (the fastest of 64, 256 and 512 on the card);
# the card-vs-CPU slice's shots, in 32-shot buckets (the CPU's plain
# decode takes half the time of one 64-shot bucket; the results do not
# depend on the bucket)
GDG_P, GDG_SHOTS = 0.005, 8192
REF_GDG_FAILED, REF_GDG_SHOTS = 400, 5000
GDG_FAILED = 675
GDG_BUCKET = 512
GDG_SLICE_SHOTS, GDG_SLICE_BUCKET = 64, 32
# code capacity: the [[882,24]] QC-GHP code (Misc.ipynb cell 10) at p=0.04,
# 65536 shots from seed 2024 through ``data_qubit_noise_decoding``; the
# reference's rates (docs/PARITY.md) and the port's own counts at seed
# 2024 (its first run on the card, PERF.md), for BPGD at max_step 100 and
# BP+OSD-0 / OSD-CS-10
CC_P, CC_SHOTS = 0.04, 65536
CC_REF = {"bpgd": (551, 1_000_000), "osd0": (26, 1_000_000), "osdcs": (1, 1_000_000)}
CC_FAILED = {"bpgd": 30, "osd0": 2, "osdcs": 0}
# the device-resident campaign: BPGD over all VNs on [[882]] (34/1e6) and
# GDG's spans form on [[288,12,18]] at p=0.02 (1/1e7), 65536 shots each
CC_DEVICE_SHOTS = 65536
CC_DEVICE_REF = {"bpgd_all": (34, 1_000_000), "gdg_288": (1, 10_000_000)}
# the first shots of the [[882]] samples, decoded on the card and on the CPU
CC_SLICE_SHOTS = 256
# the [[882]] shots whose first OSD bucket holds kernel B against its plain
# version at 441x882
CC_OSD_CHECK_SHOTS = 8192
# which kernels each code-capacity decoder may launch
CC_KERNELS = {"bpgd": ("bp_span_pinned",), "osd0": ("bp_span", "gauss_jordan_key"),
              "osdcs": ("bp_span", "osd_cs_fused"), "bpgd_all": ("bp_span_pinned",),
              "gdg_288": ("bp_span", "bp_span_pinned")}


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def phase_build():
    from slidingwindowdecoder_torch.ops import bp_cuda, gf2_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    t0 = time.perf_counter()
    secs = cuda_build.build([bp_cuda.SOURCE, bp_cuda.SPAN_SOURCE, gf2_cuda.SOURCE])
    log(f"[build] {time.perf_counter() - t0:.1f}s wall; per source {secs}")
    for src, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {src}: {line.strip()}")


def phase_cn(plan):
    import torch

    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops.bp import _cn_update_sm
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update

    g = compile_graph(plan.windows[1].mat)
    garr = graph_tensors(g, "cuda")
    valid = garr["cn_valid_sm"]
    dc, m_pad = g.dc, g.m_pad
    gen = torch.Generator(device="cuda").manual_seed(7)
    result = {"max_abs_err": 0.0}
    for B in (1024, 16384):
        for dtype in (torch.float32, torch.bfloat16):
            mv = torch.randn((dc, m_pad, B), generator=gen, device="cuda") * 30
            mv[1, ::3] = -mv[0, ::3]  # ties of |x| between slots 0 and 1
            mv[2, ::5] = mv[3, ::5]  # equal values
            mv[4, ::7] = 0.0  # zeros count as negative
            mv = mv.to(dtype)
            parity = torch.randint(0, 2, (m_pad, B), generator=gen, device="cuda",
                                   dtype=torch.int32)
            before = cn_update.launches
            out = cn_update(mv, valid, parity, alpha=1.0, clip=50.0)
            torch.cuda.synchronize()
            if cn_update.launches != before + 1:
                raise SystemExit("kernel A was not launched")
            ref = _cn_update_sm(mv, valid, parity, alpha=1.0, clip=50.0)
            err = float((out.float() - ref.float()).abs().max())
            same = torch.equal(out, ref)
            ms = cuda_time_ms(lambda: cn_update(mv, valid, parity, alpha=1.0, clip=50.0), 50)
            plain_ms = cuda_time_ms(
                lambda: _cn_update_sm(mv, valid, parity, alpha=1.0, clip=50.0), 5)
            nbytes = 2 * mv.numel() * mv.element_size() + parity.numel() * 4 + valid.numel()
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            log(f"[cn] [{dc},{m_pad},{B}] {str(dtype)[6:]}: bit-exact={same} "
                f"max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms (bytes {nbytes})")
            if not same:
                raise SystemExit(f"kernel A disagrees with its plain version at B={B} {dtype}")
            result["max_abs_err"] = max(result["max_abs_err"], err)
            if B == 16384 and dtype == torch.bfloat16:  # phase A of the main path
                result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              shape=f"[{dc},{m_pad},{B}] bf16")
    cn_update.launches = 0
    return result


def phase_cn_pinned(plan):
    """The pinned kernel against its plain version at the shapes of the
    masked BP: the flagship window (pre-BP at 16384 shots, post-BP buckets
    of 512), a [[288]] W=4 window and the [[144]] global DEM graph (the
    shapes where the TPU kernel faulted its worker)."""
    import torch

    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.ops.bp import PIN, _cn_update_sm
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update

    _, _, dem144, _ = build_bb_window_experiment(144, 0.004, 12, 3, 1)
    _, _, _, plan288 = build_bb_window_experiment(288, 0.005, 6, 4, 1)
    cases = [(plan.windows[1].mat, 512), (plan.windows[1].mat, 16384),
             (plan288.windows[1].mat, 1024), (dem144.chk, 1024)]
    gen = torch.Generator(device="cuda").manual_seed(13)
    result = {"max_abs_err": 0.0}
    for H, B in cases:
        g = compile_graph(H)
        valid = graph_tensors(g, "cuda")["cn_valid_sm"]
        dc, m_pad = g.dc, g.m_pad
        for dtype in (torch.float32, torch.bfloat16):
            mv = torch.randn((dc, m_pad, B), generator=gen, device="cuda") * 30
            mv[1, ::3] = -mv[0, ::3]  # ties of |x| between slots 0 and 1
            mv[2, ::5] = mv[3, ::5]  # equal values
            mv[4, ::7] = 0.0  # zeros count as negative
            mv[5, ::11] = 80.0  # beyond +clip
            mv[6, ::13] = -75.0  # beyond -clip
            mv = mv.to(dtype)
            mv[torch.rand(mv.shape, generator=gen, device="cuda") < 0.3] = PIN
            mv[:, ::9] = PIN  # every edge of these checks pinned
            parity = torch.randint(0, 2, (m_pad, B), generator=gen, device="cuda",
                                   dtype=torch.int32)

            def kern():
                return cn_update(mv, valid, parity, alpha=1.0, clip=50.0, pinned=True)

            before = cn_update.pinned_launches, cn_update.launches
            out = kern()
            torch.cuda.synchronize()
            if (cn_update.pinned_launches, cn_update.launches) != (before[0] + 1, before[1]):
                raise SystemExit("the pinned kernel was not launched exactly once")
            ref = _cn_update_sm(mv, valid, parity, alpha=1.0, clip=50.0, pinned=True)
            err = float((out.float() - ref.float()).abs().max())
            same = torch.equal(out, ref)
            ms = cuda_time_ms(kern, 50)
            plain_ms = cuda_time_ms(
                lambda: _cn_update_sm(mv, valid, parity, alpha=1.0, clip=50.0, pinned=True), 5)
            nbytes = 2 * mv.numel() * mv.element_size() + parity.numel() * 4 + valid.numel()
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            shape = f"[{dc},{m_pad},{B}] {str(dtype)[6:]}"
            log(f"[cn_pinned] {H.shape[0]}x{H.shape[1]} {shape}: bit-exact={same} "
                f"max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms (bytes {nbytes})")
            if not same:
                raise SystemExit(f"the pinned kernel disagrees with its plain version at {shape}")
            result["max_abs_err"] = max(result["max_abs_err"], err)
            if m_pad == 224 and B == 512 and dtype == torch.float32:  # post-BP bucket
                result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, shape=shape)
    cn_update.launches = cn_update.pinned_launches = 0
    return result


def _gj_ops(m: int, n: int, W: int, rank: int, B: int, xor_rows: int) -> int:
    """32-bit operations of the elimination on these inputs: per step the
    OR over the unused rows' words, the key scan and the pivot-column bit
    test, and the W+1 word XORs of every row that holds the pivot bit
    (``xor_rows``, summed over steps and shots, counted by the plain
    version)."""
    per_shot = sum((m - r) * W + n + m for r in range(rank))
    return per_shot * B + xor_rows * (W + 1)


# kernel B (csrc/gauss_jordan.cu) per 256-shot bucket at 216x1728 before
# the fused design (PERF.md, PR 3's chip runs)
GJ_BEFORE_MS = 1.928


def _tie_keys(gen, B: int, n: int):
    """Coarse keys with many exact ties, resolved to the lower column, and
    -0.0 and +0.0 on columns of their own (equal keys too)."""
    import torch

    key = torch.randint(-32, 32, (B, n), generator=gen, device="cuda").float() * 0.25
    key[:, ::11] = -0.0
    key[:, 5::11] = 0.0
    return key


def _sweep_work(gj, key, pair_i, pair_j, order_w: int, solution):
    """The OSD-CS sweep's work on these inputs, by kind: 32-bit integer
    operations (a test of each word of the reduced state for a_j, of each
    row word of a pair's two columns for its Gram term, and of each row's
    bit of the order_w columns); float32 operations (an add per set bit of
    a non-pivot column for a_j and per row holding both columns of a pair
    for its Gram term, an add per OSD-0 support column for pm0, two adds
    and a compare per non-pivot column for pm_w1, five adds, a multiply
    and a compare per pair for pm_w2); float64 adds (one per support
    column of the solution, for min_pm). Returns (int32, float32, float64)
    counts over the bucket."""
    import torch

    from slidingwindowdecoder_torch.ops.gf2_solve import (
        _extract_bitcols,
        _top_nonpivot_columns,
    )

    red = gj["reduced_wm"]  # [W, m, B]
    W, m, B = red.shape
    n, rank, P = key.shape[1], gj["piv_col"].shape[1], pair_i.shape[0]
    k = n - rank
    set_bits = sum(int(((red >> s) & 1).sum()) for s in range(32))  # rank in pivot columns
    nonpiv = torch.ones((n, B), dtype=torch.bool, device=red.device)
    nonpiv.scatter_(0, gj["piv_col"].T.long(), False)
    cols = _extract_bitcols(red, _top_nonpivot_columns(key.T.float(), nonpiv, order_w))
    both = int((cols[pair_i.long()] * cols[pair_j.long()]).sum())
    int_ops = B * (m * W + P * 2 * -(-m // 32) + order_w * m)
    f32_ops = set_bits - rank * B + both + int(gj["osd0"].sum()) + B * (3 * k + 7 * P)
    return int_ops, f32_ops, int(solution.sum())


def _gj_case(label, Hw, synd, key, *, m: int, n: int, rank: int, **_):
    """``gauss_jordan_key`` on the card against ``ordered_gauss_jordan_key``
    on the same inputs, every output bit-exact; then its time, the plain
    version's and the bound."""
    import torch

    from slidingwindowdecoder_torch.ops.gf2_cuda import gauss_jordan_key
    from slidingwindowdecoder_torch.ops.gf2_solve import ordered_gauss_jordan_key

    W, B = Hw.shape[1], synd.shape[0]
    before = gauss_jordan_key.launches
    out = gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank)
    torch.cuda.synchronize()
    if gauss_jordan_key.launches != before + 1:
        raise SystemExit("kernel B was not launched")
    ref = ordered_gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank)
    bad = [k for k in ref if not torch.equal(out[k], ref[k])]
    err = max(float((out[k].double() - ref[k].double()).abs().max()) for k in ref)
    ms = cuda_time_ms(lambda: gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank), 20)
    plain_ms = cuda_time_ms(
        lambda: ordered_gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank), 2)
    xor_rows = int(ordered_gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank,
                                            count_xor=True)["xor_rows"].sum())
    ops = _gj_ops(m, n, W, rank, B, xor_rows)
    nbytes = Hw.numel() * 4 + synd.numel() + key.numel() * 4 + B * (
        m * (W + 1) * 4 + 2 * rank * 4 + 1)
    ops_ms, bytes_ms = ops / INT32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    n_incons = int(out["inconsistent"].sum())
    log(f"[gj] {label} rank {rank} B={B}: bit-exact={not bad} max_abs_err={err} "
        f"inconsistent {n_incons}/{B}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms (ops {ops}, {xor_rows} rows XORed -> {ops_ms:.5f} ms, "
        f"bytes {nbytes} -> {bytes_ms:.5f} ms)")
    if bad:
        raise SystemExit(f"[gj] {label}: kernel B disagrees with its plain version on {bad}")
    gauss_jordan_key.launches = 0
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "shape": f"{m}x{n} B={B}"}


def phase_gj(plan):
    """Kernel B's elimination entry point on tie keys (random syndromes)
    at 216x1656 and 216x1728 (``_gj_case``); the kernels line keeps the
    216x1728 case."""
    import torch

    from slidingwindowdecoder_torch.ops.gf2_solve import gf2_rank_packed, pack_rows_host

    gen = torch.Generator(device="cuda").manual_seed(11)
    B = 256
    result = {"max_abs_err": 0.0}
    for spec in (plan.windows[1], plan.windows[-1]):
        H = spec.mat
        m, n = H.shape
        Hw = torch.as_tensor(pack_rows_host(H).view(np.int32), device="cuda")
        synd = torch.randint(0, 2, (B, m), generator=gen, device="cuda", dtype=torch.uint8)
        r = _gj_case(f"{m}x{n}", Hw, synd, _tie_keys(gen, B, n), m=m, n=n,
                     rank=gf2_rank_packed(H))
        result["max_abs_err"] = max(result["max_abs_err"], r["max_abs_err"])
        if n == 1728:
            result.update(r, max_abs_err=result["max_abs_err"])
    return result


def _first_osd_bucket(module, decoder, synd):
    """The arguments of the first ``osd_decode`` call of ``decoder`` (whose
    module is ``module``) in one ``core`` call on ``synd``."""
    orig, seen = module.osd_decode, []

    def first(*a, **k):
        if not seen:
            seen.append((a, k))
        return orig(*a, **k)

    module.osd_decode = first
    try:
        decoder.core(synd)
    finally:
        module.osd_decode = orig
    return seen[0]


def _osd_cs_case(label, Hw, s, key, llr, *, m: int, n: int, rank: int, meta: dict, **_):
    """``osd_cs_fused`` on the card against the plain elimination and sweep
    on the same inputs: solution, OSD-0, inconsistency and the bits of
    min_pm equal; then its time beside the standalone elimination's,
    kernel B's before the fused design, the plain version's and the
    bound."""
    import torch

    from slidingwindowdecoder_torch.ops.gf2_cuda import gauss_jordan_key, osd_cs_fused
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        _osd_sweep_cs_sortless,
        ordered_gauss_jordan_key,
    )

    W, Bc = Hw.shape[1], s.shape[0]
    pi, pj = (torch.as_tensor(meta[k], dtype=torch.int32, device="cuda")
              for k in ("pair_i", "pair_j"))
    ow = int(meta["order_w"])

    def fused():
        return osd_cs_fused(Hw, s, key, llr, pi, pj, m=m, n=n, rank=rank, order_w=ow)

    def plain(count_xor=False):
        gj = ordered_gauss_jordan_key(Hw, s, key, m=m, n=n, rank=rank, count_xor=count_xor)
        return gj, _osd_sweep_cs_sortless(gj, key, llr, pi, pj, order_w=ow)

    before = osd_cs_fused.launches
    out = fused()
    torch.cuda.synchronize()
    if osd_cs_fused.launches != before + 1:
        raise SystemExit("the fused OSD-CS kernel was not launched")
    gj, (sol, min_pm) = plain(count_xor=True)
    pairs = {"solution": (out["solution"], sol), "osd0": (out["osd0"], gj["osd0"]),
             "inconsistent": (out["inconsistent"], gj["inconsistent"]),
             "min_pm": (out["min_pm"].view(torch.int32), min_pm.view(torch.int32))}
    bad = [k for k, (x, y) in pairs.items() if not torch.equal(x, y)]
    err = max(float((out[k].double() - y.double()).abs().max())
              for k, y in (("solution", sol), ("osd0", gj["osd0"]), ("min_pm", min_pm)))
    ms = cuda_time_ms(fused, 20)
    gj_ms = cuda_time_ms(lambda: gauss_jordan_key(Hw, s, key, m=m, n=n, rank=rank), 20)
    plain_ms = cuda_time_ms(plain, 2)
    xor_rows = int(gj["xor_rows"].sum())
    int_ops, f32_ops, f64_adds = _sweep_work(gj, key, pi, pj, ow, sol)
    int_ops += _gj_ops(m, n, W, rank, Bc, xor_rows)
    nbytes = (Hw.numel() * 4 + s.numel() + key.numel() * 4 + n * 4 + 8 * pi.shape[0]
              + Bc * (2 * n + 5))
    ops_ms = 1e3 * max(int_ops / INT32_OPS_PER_S, f32_ops / FP32_OPS_PER_S,
                       f64_adds / FP64_ADDS_PER_S)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    n_cand = int((sol != gj["osd0"]).any(dim=1).sum())
    log(f"[osd_cs] {label} B={Bc}: bit-exact={not bad} max_abs_err={err}; "
        f"{n_cand} shots take a candidate, {int(gj['inconsistent'].sum())} inconsistent; "
        f"fused {ms:.4f} ms, elimination alone {gj_ms:.4f} ms, before {GJ_BEFORE_MS} ms "
        f"(kernel B at 216x1728), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms (int32 "
        f"{int_ops} with {xor_rows} rows XORed, float32 {f32_ops}, float64 {f64_adds} "
        f"-> {ops_ms:.5f} ms, bytes {nbytes} -> {bytes_ms:.5f} ms)")
    if bad:
        raise SystemExit(f"[osd_cs] {label}: the fused kernel disagrees with its plain "
                         f"version on {bad}")
    gauss_jordan_key.launches = osd_cs_fused.launches = 0
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "shape": f"{m}x{n} B={Bc}"}


def phase_osd_cs(plan, det):
    """The fused OSD-CS launch (``_osd_cs_case``) on tie keys (random
    syndromes) at 216x1728 and 216x1656 and on the first OSD bucket of
    window 0 of each path; the kernels line keeps the 216x1728 tie-key
    case."""
    import torch

    from slidingwindowdecoder_torch.decoders import bposd, osd_window
    from slidingwindowdecoder_torch.harness.circuit_level import window_decoder_factory
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        analyze_patterns,
        gf2_rank_packed,
        osd_candidate_patterns,
        pack_rows_host,
    )

    gen = torch.Generator(device="cuda").manual_seed(12)
    B = 256
    cases = []
    for spec in (plan.windows[1], plan.windows[-1]):
        m, n = spec.mat.shape
        rank = gf2_rank_packed(spec.mat)
        p = np.asarray(spec.prior, np.float64)
        meta = analyze_patterns(osd_candidate_patterns(n - rank, 10, "osd_cs"), n - rank)
        cases.append((f"{m}x{n} tie keys", (
            torch.as_tensor(pack_rows_host(spec.mat).view(np.int32), device="cuda"),
            (torch.rand((B, m), generator=gen, device="cuda") < 0.1).to(torch.uint8),
            _tie_keys(gen, B, n),
            torch.as_tensor(np.log((1 - p) / p).astype(np.float32), device="cuda")),
            dict(m=m, n=n, rank=rank, meta=meta)))
    spec = plan.windows[0]
    synd = torch.as_tensor(det[:, spec.row_start:spec.row_end], device="cuda")
    for label, module, factory in (
            ("flagship", bposd, window_decoder_factory(False, device="cuda", **FLAGSHIP_KNOBS)),
            ("shortened", osd_window, window_decoder_factory(True, device="cuda"))):
        args, kw = _first_osd_bucket(module, factory(spec), synd)
        m, n = spec.mat.shape
        cases.append((f"{label} window 0, first OSD bucket ({m}x{n})", args[:4], kw))

    result = {"max_abs_err": 0.0}
    for label, args, kw in cases:
        r = _osd_cs_case(label, *args, **kw)
        result["max_abs_err"] = max(result["max_abs_err"], r["max_abs_err"])
        if label.startswith("216x1728"):
            result.update(r, max_abs_err=result["max_abs_err"], shape=r["shape"] + ", tie keys")
    return result


def phase_osd_882(code, synd, gj, osd_cs):
    """Kernel B at the [[882]] code-capacity shape (441x882): the arguments
    of the first ``osd_decode`` call of the cc882 BP+OSD-0 and
    BP+OSD-CS-10 decoders on ``synd`` (real syndromes, BP reliabilities),
    through ``gauss_jordan_key`` (OSD-0) and ``osd_cs_fused`` (OSD-CS)
    against their plain versions, bit-exact (``_gj_case``,
    ``_osd_cs_case``). The results go into the kernels line under
    ``cc882_osd0`` / ``cc882_osdcs`` of ``gj`` / ``osd_cs``."""
    import torch

    from slidingwindowdecoder_torch.decoders import bposd
    from slidingwindowdecoder_torch.harness.code_capacity import parity_decoder

    synd = torch.as_tensor(synd, device="cuda")
    for which, res, case in (("osd0", gj, _gj_case), ("osdcs", osd_cs, _osd_cs_case)):
        args, kw = _first_osd_bucket(
            bposd, parity_decoder(code, CC_P, which, device="cuda"), synd)
        r = case(f"[[882]] BP+{which.upper()}, first OSD bucket",
                 *args[:3 if which == "osd0" else 4], **kw)
        res[f"cc882_{which}"] = r
        res["max_abs_err"] = max(res["max_abs_err"], r["max_abs_err"])


def _span_diff(label, out, ref):
    """Hold the fused kernel's outputs ``out`` against the plain loop's
    ``ref`` (CPU tensors, the same shots): error, done, iterations,
    history and ``synd_hat`` (where returned) bit-exact, and the messages
    of every shot the plain loop left not done. Returns max_abs_err."""
    import torch

    live = ~ref[3]
    pairs = {"messages": (out[0][:, :, live], ref[0][:, :, live]), "history": (out[1], ref[1]),
             "error": (out[2], ref[2]), "done": (out[3], ref[3]), "iters": (out[4], ref[4])}
    if len(ref) > 5:
        pairs["synd_hat"] = (out[5], ref[5])
    bad = [k for k, (x, y) in pairs.items() if not torch.equal(x, y)]
    err = max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
              for x, y in pairs.values())
    log(f"[bp_span] {label}: bit-exact={not bad} max_abs_err={err}")
    if bad:
        raise SystemExit(f"[bp_span] {label}: the kernel disagrees with the plain loop on {bad}")
    return err


def _span_case(label, args, kw, cpu_garr, reps: int):
    """One ``bp_span`` input on the card against the plain loop on the CPU
    (``_span_diff``), then its time, the per-op CUDA loop's time and the
    bound."""
    import torch

    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.ops.bp import bp_loop

    garr, mv = args[0], args[1]
    masked = kw["masked"]
    counter = "pinned_launches" if masked else "launches"
    B, n, dc, m_pad, dv = mv.shape[2], garr["n"], garr["dc"], garr["m_pad"], garr["dv"]

    def inputs(dev):  # the history ring is written in place: a copy each
        a = [t.to(dev) if torch.is_tensor(t) else t for t in args[1:]]
        a[5] = a[5].clone()
        return (cpu_garr if dev == "cpu" else garr, *a)

    card_args = inputs("cuda")
    before = getattr(bp_cuda.bp_span, counter)
    out = [x.cpu() for x in bp_cuda.bp_span(*card_args, **kw)]
    torch.cuda.synchronize()
    if getattr(bp_cuda.bp_span, counter) != before + 1:
        raise SystemExit(f"[bp_span] {label}: the kernel was not launched once")
    t0 = time.perf_counter()
    ref = bp_cuda.bp_span(*inputs("cpu"), **kw)  # CPU tensors: the plain loop
    cpu_s = time.perf_counter() - t0
    err = _span_diff(label, out, ref)

    ms = cuda_time_ms(lambda: bp_cuda.bp_span(*card_args, **kw), reps)
    plain_ms = cuda_time_ms(lambda: bp_loop(*card_args, **kw), 2)  # per-op loop
    ran = ref[4] - args[9].cpu()  # iterations each shot ran in this call
    shot_iters, longest = int(ran.sum()), int(ran.max())
    edges = int(garr["cn_valid_sm"].sum())
    t = mv.element_size()
    hist_rows = ((args[5] == -1).sum(dim=1).cpu() if masked and args[5] is not None
                 else torch.full((B,), n))
    hist_writes = int(((ran - kw["hist_from"]).clamp_min(0) * hist_rows).sum())
    ops = shot_iters * (edges * SPAN_OPS_PER_EDGE + n * SPAN_OPS_PER_VN)
    # bytes of the rows not done at entry (a done row's block is neither
    # read nor compared): its message block read and written, its int32
    # syndrome and sign seed, its VN state and error, and the ring's writes
    live = int((~args[8]).sum())
    nbytes = live * (2 * dc * m_pad * t + 8 * m_pad + 2 * n) + 4 * hist_writes
    # all at the float32 rate, though the sign counts run at the integer one
    ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    # shared-memory traffic of one shot-iteration, from the code: CN two
    # reads and a write per edge; the VN gather with its indices, the
    # prior and the rounded posterior; the edge stage's index, posterior,
    # message read and write; degrees, sign seeds and syndrome per check
    smem = shot_iters * (edges * (6 * t + 2) + n * dv * (t + 2) + n * (4 + t) + 6 * m_pad)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S = bp_cuda.shots_per_block(garr, B, mv.dtype, sms)
    log(f"[bp_span] {label}: {live} of {B} rows not done at entry, {shot_iters} "
        f"shot-iterations, longest {longest}; kernel "
        f"{ms:.4f} ms ({ms / max(longest, 1):.5f} ms per iteration, {S} shots x "
        f"{bp_cuda.MAX_THREADS // S * S} threads per block, {-(-B // S)} blocks, "
        f"{bp_cuda.span_smem_bytes(garr, mv.dtype, S)} B shared), per-op loop {plain_ms:.4f} "
        f"ms, bound {max(ops_ms, bytes_ms):.5f} ms (ops {ops} -> {ops_ms:.5f} ms, bytes "
        f"{nbytes} -> {bytes_ms:.5f} ms), shared memory {smem / ms / 1e9:.1f} TB/s; CPU "
        f"plain {cpu_s:.1f}s")
    for hist_from in (0, kw["num_iter"]):  # the ring written always, or never
        hist_ms = cuda_time_ms(lambda: bp_cuda.bp_span(
            *card_args, **{**kw, "hist_from": hist_from}), reps)
        log(f"[bp_span] {label}: history from iteration {hist_from} -> {hist_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err,
            "shape": f"[{dc},{m_pad},{B}] {str(mv.dtype)[6:]}, {longest} iterations"}


def phase_bp_span(plan, det):
    """The fused kernel against the plain loop at every shape the paths
    give it, on the window-0 syndromes of the seed-2024 samples (16384
    shots). The two whole-batch calls (pre-BP: 8 masked f32 iterations;
    phase A: 16 unmasked bf16 iterations) run on the card and their first
    ``SLICE_SHOTS`` shots on the CPU (BP is per shot). Their outputs feed
    the paths' long spans: the first 512 pre-BP survivors shortened as
    ``OSDWindow`` does, then 200 masked f32 iterations; the first 1024
    phase-A survivors, then a 48-iteration phase-B span, both with the
    tail history, each timed beside the per-op loop."""
    import torch

    from slidingwindowdecoder_torch.decoders import OSDWindow
    from slidingwindowdecoder_torch.decoders.osd_window import shorten
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.ops.bp import bp_init_messages_sm, bp_run, span_inputs

    spec = plan.windows[0]
    cpu_garr = graph_tensors(compile_graph(spec.mat), "cpu")
    synd = torch.as_tensor(det[:, spec.row_start:spec.row_end], device="cuda")
    B0, n = synd.shape[0], spec.mat.shape[1]
    dec = OSDWindow(spec.mat, spec.prior, pre_max_iter=8, post_max_iter=200,
                    osd_method="osd_cs", osd_order=10, device="cuda")
    garr, llr = dec.garr, torch.as_tensor(dec.llr, device="cuda")

    def state(b, dev="cuda"):
        return (torch.zeros((n, 4, b), device=dev),
                torch.zeros((b, n), dtype=torch.int8, device=dev),
                torch.zeros((b,), dtype=torch.bool, device=dev),
                torch.zeros((b,), dtype=torch.int32, device=dev))

    def whole_batch(label, masked, **kw):
        """``bp_run`` from fresh messages over all shots: one launch on the
        card, the first ``SLICE_SHOTS`` shots by the plain loop on the CPU.
        Returns the card's outputs and max_abs_err on the slice."""
        counter = "pinned_launches" if masked else "launches"

        def run(g, s):
            dev, prior = s.device, llr.to(s.device)
            mv0 = bp_init_messages_sm(g, prior, s.shape[0], kw.get("msg_dtype", "float32"))
            return bp_run(g, mv0, prior, s, *state(s.shape[0], dev), freeze_messages=False,
                          io_layout="slot_major", masked=masked, **kw)

        before = getattr(bp_cuda.bp_span, counter)
        out = run(garr, synd)
        torch.cuda.synchronize()
        if getattr(bp_cuda.bp_span, counter) != before + 1:
            raise SystemExit(f"[bp_span] {label}: the kernel was not launched once")
        k = SLICE_SHOTS
        t0 = time.perf_counter()
        ref = run(cpu_garr, synd[:k].cpu())
        cpu_s = time.perf_counter() - t0
        head = [out[0][:, :, :k], out[1][:, :, :k], *(x[:k] for x in out[2:])]
        err = _span_diff(f"{label}, first {k} shots (CPU plain {cpu_s:.1f}s)",
                         [x.cpu() for x in head], ref)
        return out, err

    res = {}
    # a post-BP bucket: pre-BP survivors, shortened and peeled
    (_, hist, _, done, _), pre_err = whole_batch(
        f"pre-BP masked f32 B={B0}, 8 iterations", True, num_iter=8)
    idx = torch.argsort(done.to(torch.int32), stable=True)[:512]
    vn, cn, dead = shorten(garr, synd[idx], hist[:, :, idx], dec.new_n)
    h, _, _, it = state(512)
    args, kw = span_inputs(
        garr, bp_init_messages_sm(garr, llr, 512), llr, synd[idx], h,
        torch.where(vn != -1, vn, 0).to(torch.int8), dead, it, num_iter=200,
        freeze_messages=False, history_mode="tail", io_layout="slot_major",
        vn_state=vn, cn_state=cn, masked=True)
    log(f"[bp_span] post-BP bucket: {float((vn != -1).float().mean()):.3f} of the VNs "
        f"decided, {int(dead.sum())} shots dead")
    res["bp_span_pinned"] = _span_case("masked f32 B=512", args, kw, cpu_garr, 10)
    # a phase-B bucket: phase-A survivors
    (mv, _, err, done, iters), a_err = whole_batch(
        f"phase A unmasked bf16 B={B0}, 16 iterations", False, num_iter=16,
        msg_dtype="bfloat16", history_mode="none")
    idx = torch.argsort(done.to(torch.int32), stable=True)[:1024]
    args, kw = span_inputs(
        garr, mv[:, :, idx], llr, synd[idx], state(1024)[0], err[idx], done[idx], iters[idx],
        num_iter=48, msg_dtype="bfloat16", freeze_messages=False, history_mode="tail",
        io_layout="slot_major")
    res["bp_span"] = _span_case("unmasked bf16 B=1024", args, kw, cpu_garr, 10)
    for name, e in (("bp_span_pinned", pre_err), ("bp_span", a_err)):
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], e)
    return res


class _Captured(Exception):
    """Ends a decode once the call of interest has been captured."""


def phase_bp_span_gdg(plan, det, bucket: int):
    """The GDG ensemble's BP burst: the arguments of the masked ``bp_run``
    of step 4 of the first ensemble bucket of window 0 (the step after the
    tree-side branches restarted their messages at depth 3), captured from
    a decode on the card, then ``bp_span_pinned`` on them against the plain
    loop on the CPU (``_span_case``), ``synd_hat`` included. Also times the
    call's layout conversions (``span_inputs``: the transposes of the
    [n, B] int8 states, the int32 syndrome and sign seed, the ring's
    copy)."""
    import torch

    from slidingwindowdecoder_torch.decoders import gdg
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.harness.circuit_level import gdg_window_factory
    from slidingwindowdecoder_torch.ops.bp import span_inputs

    spec = plan.windows[0]
    cpu_garr = graph_tensors(compile_graph(spec.mat), "cpu")
    dec = gdg_window_factory(max_iter=8, ensemble_bucket=bucket, device="cuda")(spec)
    synd = torch.as_tensor(det[:, spec.row_start:spec.row_end], device="cuda")
    calls, orig = [], gdg.bp_run

    def capture(*a, **k):
        calls.append((a, k))
        if len(calls) == 5:
            raise _Captured
        return orig(*a, **k)

    gdg.bp_run = capture
    try:
        dec.core(synd)
    except _Captured:
        pass
    finally:
        gdg.bp_run = orig
    if len(calls) < 5:
        raise SystemExit("[bp_span] GDG: the first bucket's ensemble ended before step 4")
    a, k = calls[4]
    k = {key: v for key, v in k.items()
         if key not in ("return_synd", "hist_update", "state_layout", "hist_dtype")}
    args, kw = span_inputs(*a, **k, transposed=True)
    kw["return_synd"] = True
    BN = args[1].shape[2]
    active = int((~args[8]).sum())
    log(f"[bp_span] GDG burst: {BN} columns ({BN // dec.NB} shots x {dec.NB} branches), "
        f"{active} active, {float((args[5] != -1).float().mean()):.3f} of the VNs decided; "
        f"{int(dec.tables['reinit'][:, 3].sum())} branches of each shot "
        f"restarted their messages at depth 3")
    res = _span_case(f"GDG burst masked f32 B={BN}", args, kw, cpu_garr, 20)
    res["prep_ms"] = cuda_time_ms(lambda: span_inputs(*a, **k, transposed=True), 20)
    log(f"[bp_span] GDG burst: layout conversions at the call {res['prep_ms']:.4f} ms "
        f"beside the kernel's {res['ms']:.4f} ms")
    return res


# the flagship's bench knobs (bench.py:76-136); the shortened path runs
# ``sliding_window_decoder(shorten=True)``'s decoder at its defaults
FLAGSHIP_KNOBS = dict(bp_bucket=1024, osd_bucket=256, phase_a_iters=16,
                      phase_b_spans=(48, 136), msg_dtype="bfloat16")


def reset_counts():
    """Every kernel wrapper's launch and plain-call count to 0."""
    from slidingwindowdecoder_torch.ops import bp_cuda, gf2_cuda

    for k in (bp_cuda.cn_update, bp_cuda.bp_span):
        k.launches = k.pinned_launches = k.plain_calls = 0
    for k in (gf2_cuda.gauss_jordan_key, gf2_cuda.osd_cs_fused):
        k.launches = k.plain_calls = 0


def read_counts():
    """(launches by kernel, plain calls by wrapper) since ``reset_counts``."""
    from slidingwindowdecoder_torch.ops import bp_cuda, gf2_cuda

    cn, span = bp_cuda.cn_update, bp_cuda.bp_span
    gj, osd = gf2_cuda.gauss_jordan_key, gf2_cuda.osd_cs_fused
    launches = {"bp_span": span.launches, "bp_span_pinned": span.pinned_launches,
                "cn_update": cn.launches, "cn_update_pinned": cn.pinned_launches,
                "gauss_jordan_key": gj.launches, "osd_cs_fused": osd.launches}
    plain = {"bp_span": span.plain_calls, "cn_update": cn.plain_calls,
             "gauss_jordan_key": gj.plain_calls, "osd_cs_fused": osd.plain_calls}
    return launches, plain


def check_kernels(name, launches, plain, kernels):
    """Every kernel in ``kernels`` launched, no other one, no plain call."""
    ran = {k for k, v in launches.items() if v}
    if ran != set(kernels) or any(plain.values()):
        raise SystemExit(f"{name} did not run on its kernels {kernels}: {launches} {plain}")


def phase_path(name, plan, det, obs, factory, num_repeat: int, ref, exact: int, kernels):
    """Drive one decode path on the card over all of ``det``, with the
    launch counts set to 0 just before and read just after. The failure
    count must equal ``exact`` and lie within 3 sigma of the rate ``ref``
    = (failed, shots); every kernel named in ``kernels`` must have
    launched, every other kernel and every plain version must not have
    run. Returns the counts, times and launches, and the corrections
    (``e_hat``, on the host)."""
    import torch

    from slidingwindowdecoder_torch.windows.pipeline import (
        decode_sliding_window,
        evaluate_logical_errors,
    )

    shots = det.shape[0]
    for w in plan.windows:  # set-up: decoders and graph tables on the card
        factory(w)
    det_dev = torch.as_tensor(det, device="cuda")
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    out = decode_sliding_window(plan, det_dev, factory, device="cuda", verbose=False,
                                collect_window_stats=False, sync_per_window=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, plain = read_counts()

    e_hat = out["total_e_hat"]
    if tuple(e_hat.shape) != (shots, plan.chk.shape[1]) or int(e_hat.max()) > 1:
        raise SystemExit(f"{name}: bad e_hat {tuple(e_hat.shape)}")
    ev = evaluate_logical_errors(plan, det, obs, e_hat, device="cuda")
    nf = ev["num_failed"]
    ler_round = 1 - (1 - nf / shots) ** (1 / num_repeat)
    wsec = np.asarray(out["window_seconds"])
    log(f"[{name}] {shots} shots in {dt:.3f}s -> {shots / dt:.1f} shots/s; window p50 "
        f"{np.percentile(wsec, 50) * 1e3:.1f} ms p99 {np.percentile(wsec, 99) * 1e3:.1f} ms; "
        f"failed {nf} flagged {ev['num_flagged']} (LER/round {ler_round:.4e}); "
        f"non-converged per window {out['window_nonconverged']}")
    for i, (c, sec) in enumerate(zip(out["window_counts"], wsec)):
        log(f"[{name}] window {i}: post-BP {c['post_bp']}, OSD {c['osd']}, "
            f"dead {c['dead']}, {sec * 1e3:.1f} ms")
    log(f"[{name}] kernel launches {launches}; plain calls {plain}")
    p_ref = ref[0] / ref[1]
    mean, sigma = p_ref * shots, math.sqrt(shots * p_ref * (1 - p_ref))
    if abs(nf - mean) > 3 * sigma or nf != exact:
        raise SystemExit(f"{name}: {nf} failures, want {exact} inside "
                         f"{mean:.1f} +- 3*{sigma:.1f}")
    check_kernels(name, launches, plain, kernels)
    return {
        "shots": shots, "seconds": dt, "shots_per_s": shots / dt,
        "window_p50_s": float(np.percentile(wsec, 50)),
        "window_p99_s": float(np.percentile(wsec, 99)),
        "num_failed": nf, "num_flagged": ev["num_flagged"], "ler_per_round": ler_round,
        "window_counts": out["window_counts"], "launches": launches,
        "e_hat": e_hat.cpu().numpy(),
    }


def phase_card_vs_cpu(name, plan, det, obs, make_factory):
    """Decode ``det`` on the card and by the plain versions on the CPU. BP,
    the kernels and the plain versions' f32 sums are bit-exact between the
    two devices, so the failure counts must be equal and no shot may
    differ."""
    from slidingwindowdecoder_torch.windows.pipeline import (
        decode_sliding_window,
        evaluate_logical_errors,
    )

    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = decode_sliding_window(plan, det, make_factory(dev), device=dev, verbose=False)
        ev = evaluate_logical_errors(plan, det, obs, out["total_e_hat"], device=dev)
        res[dev] = (out["total_e_hat"].cpu().numpy(), ev["num_failed"],
                    time.perf_counter() - t0)
    diff = int((res["cuda"][0] != res["cpu"][0]).any(axis=1).sum())
    log(f"[{name}] card vs CPU plain over {det.shape[0]} shots: failed {res['cuda'][1]} vs "
        f"{res['cpu'][1]}, shots differing {diff}; {res['cuda'][2]:.1f}s card, "
        f"{res['cpu'][2]:.1f}s CPU")
    if res["cuda"][1] != res["cpu"][1] or diff:
        raise SystemExit(f"{name}: the card disagrees with the CPU plain path")


def phase_gdg_spans(plan, det, obs, num_repeat: int, host_res):
    """The GDG path again with ``ensemble_mode="spans"`` (row buckets of
    2048 columns at most, lane dormancy): the spans form computes the
    host-stepped form's results (``gdg_ensemble_spans`` says where a dead
    column could part them), so its failures, flags and every correction
    must equal ``host_res``'s. Also counts, per span of the schedule, the
    columns its steps ran on as a share of the ensemble buckets' columns
    (host-side counts: no extra read)."""
    from collections import defaultdict

    from slidingwindowdecoder_torch.decoders import gdg
    from slidingwindowdecoder_torch.harness.circuit_level import gdg_window_factory

    stepped, columns = defaultdict(int), [0]
    step, spans_fn = gdg._ensemble_step, gdg.gdg_ensemble_spans

    def counted_step(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw):
        stepped[d] += carry["vn"].shape[1]
        return step(garr, llr, synd, rank, tt, reinit_any, d, carry, **kw)

    def counted_spans(garr, llr, syndrome, *a, **kw):
        columns[0] += syndrome.shape[0] * a[-1]["num_branches"]
        return spans_fn(garr, llr, syndrome, *a, **kw)

    factory = gdg_window_factory(max_iter=8, ensemble_bucket=GDG_BUCKET,
                                 ensemble_mode="spans", device="cuda")
    gdg._ensemble_step, gdg.gdg_ensemble_spans = counted_step, counted_spans
    try:
        res = phase_path("gdg_spans", plan, det, obs, factory, num_repeat,
                         (REF_GDG_FAILED, REF_GDG_SHOTS), GDG_FAILED,
                         ("bp_span", "bp_span_pinned"))
    finally:
        gdg._ensemble_step, gdg.gdg_ensemble_spans = step, spans_fn
    differ = int((res.pop("e_hat") != host_res["e_hat"]).any(axis=1).sum())
    spans = factory(plan.windows[0]).ensemble_spans
    shares, d0 = [], 0
    for sp in spans:
        shares.append(sum(stepped[d] for d in range(d0, d0 + sp)) / max(1, sp * columns[0]))
        d0 += sp
    res.update(spans=spans, active_share_by_span=shares, ensemble_columns=columns[0],
               column_steps=sum(stepped.values()), shots_differing=differ)
    log(f"[gdg_spans] {res['shots_per_s']:.1f} shots/s (host-stepped "
        f"{host_res['shots_per_s']:.1f}); failed {res['num_failed']} flagged "
        f"{res['num_flagged']} (host-stepped {host_res['num_failed']} / "
        f"{host_res['num_flagged']}), shots differing {differ}; spans {spans}, columns "
        f"stepped per span as a share of the {columns[0]} ensemble columns "
        f"{[round(x, 4) for x in shares]}")
    if differ or res["num_flagged"] != host_res["num_flagged"]:
        raise SystemExit("[gdg_spans] the spans form disagrees with the host-stepped form")
    return res


def cc_samples(code):
    """The seed-2024 syndromes that ``data_qubit_noise_decoding`` draws at
    one batch of ``CC_SHOTS`` shots."""
    rng = np.random.default_rng(SEED)
    err = (rng.random((CC_SHOTS, code.N)) < CC_P).astype(np.float32)
    return ((err @ code.hx.T.astype(np.float32)) % 2).astype(np.uint8)


def phase_bp_span_bpgd(code, synd):
    """The BPGD burst at its real shape: the arguments of the fourth masked
    ``bp_run`` of ``BPGD.core`` (spans mode, max_step 100) on the [[882]]
    syndromes (step 3 of the first bucket of ``row_bucket`` rows; 12
    iterations, slot-major carry, batch-major states), captured on the
    card, then ``bp_span_pinned`` on them against the plain loop on the
    CPU (``_span_case``)."""
    import torch

    from slidingwindowdecoder_torch.decoders import bpgd
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.harness.code_capacity import parity_decoder
    from slidingwindowdecoder_torch.ops.bp import span_inputs

    dec = parity_decoder(code, CC_P, "bpgd", {"max_step": 100}, device="cuda")
    calls, orig = [], bpgd.bp_run

    def capture(*a, **k):
        calls.append((a, k))
        if len(calls) == 4:
            raise _Captured
        return orig(*a, **k)

    bpgd.bp_run = capture
    try:
        dec.core(torch.as_tensor(synd, device="cuda"))
    except _Captured:
        pass
    finally:
        bpgd.bp_run = orig
    if len(calls) < 4:
        raise SystemExit("[bp_span] BPGD: the first bucket halted before step 3")
    a, k = calls[3]
    args, kw = span_inputs(*a, **{key: v for key, v in k.items() if key != "hist_update"})
    B = args[1].shape[2]
    log(f"[bp_span] BPGD burst: {B} rows ({int((~args[8]).sum())} active), "
        f"{float((args[5] != -1).float().mean()):.4f} of the VNs decided")
    return _span_case(f"BPGD burst masked f32 B={B}", args, kw,
                      graph_tensors(compile_graph(code.hx), "cpu"), 20)


def phase_cc_host(code):
    """``[cc_bpgd]`` and ``[cc_osd]``: [[882]] at p=0.04 through
    ``data_qubit_noise_decoding`` (seed 2024, one batch of ``CC_SHOTS``),
    BPGD at max_step 100, BP+OSD-0 and BP+OSD-CS-10, each with the launch
    counts read around its run: its failures equal to ``CC_FAILED`` and
    within 3 sigma of the reference's rate (``rates_compatible``)."""
    import torch

    from slidingwindowdecoder_torch.harness.code_capacity import (
        data_qubit_noise_decoding,
        parity_decoder,
    )
    from slidingwindowdecoder_torch.utils.metrics import rates_compatible

    res = {}
    for name, ov in (("bpgd", {"max_step": 100}), ("osd0", {}), ("osdcs", {})):
        tag = "cc_bpgd" if name == "bpgd" else "cc_osd"
        dec = parity_decoder(code, CC_P, name, ov, device="cuda")
        reset_counts()
        r = data_qubit_noise_decoding(code, CC_P, CC_SHOTS, {name: dec}, batch_size=CC_SHOTS,
                                      seed=SEED, verbose=False)[name]
        torch.cuda.synchronize()
        launches, plain = read_counts()
        nf, ref = r["num_err"], CC_REF[name]
        ok = rates_compatible(nf, r["shots"], *ref)
        log(f"[{tag}] {name}: failed {nf} flagged {r['num_flagged']} of {r['shots']} "
            f"(LER {r['ler']:.3e}; reference {ref[0]}/{ref[1]}, within 3 sigma: {ok}); "
            f"{r['shots_per_sec']:.1f} shots/s ({r['seconds']:.2f}s); launches {launches}; "
            f"plain calls {plain}")
        if not ok or nf != CC_FAILED[name]:
            raise SystemExit(f"[{tag}] {name}: {nf} failures, want {CC_FAILED[name]} within "
                             f"3 sigma of {ref[0]}/{ref[1]}")
        check_kernels(f"[{tag}] {name}", launches, plain, CC_KERNELS[name])
        res[name] = {"num_failed": nf, "num_flagged": r["num_flagged"], "shots": r["shots"],
                     "seconds": r["seconds"], "shots_per_s": r["shots_per_sec"],
                     "launches": launches}
    return res


def phase_cc_device(code882):
    """``[cc_device]``: ``run_cc_campaign_device`` on ``CC_DEVICE_SHOTS``
    shots (one batch, seed 2024) for BPGD over all VNs on [[882]] at p=0.04
    and GDG's spans form on [[288,12,18]] at p=0.02 (low_error_mode,
    factor 0.625, ensemble buckets of 1024 shots: 47 branches, 48,128
    columns), each held within 3 sigma of its reference's rate."""
    from slidingwindowdecoder_torch.harness.code_capacity import parity_code, parity_decoder
    from slidingwindowdecoder_torch.harness.device_campaign import run_cc_campaign_device
    from slidingwindowdecoder_torch.utils.metrics import rates_compatible

    res = {}
    for name, code, p, which, ov in (
            ("bpgd_all", code882, CC_P, "bpgd", {}),
            ("gdg_288", parity_code(288), 0.02, "gdg", {"ensemble_mode": "spans"})):
        dec = parity_decoder(code, p, which, ov, device="cuda")
        reset_counts()
        r = run_cc_campaign_device(code, p, CC_DEVICE_SHOTS, dec, batch=CC_DEVICE_SHOTS,
                                   seed=SEED)
        launches, plain = read_counts()
        nf, ref = r["num_err"], CC_DEVICE_REF[name]
        ok = rates_compatible(nf, r["shots"], *ref)
        log(f"[cc_device] {name}: failed {nf} flagged {r['num_flagged']} of {r['shots']} "
            f"(reference {ref[0]}/{ref[1]}, within 3 sigma: {ok}); {r['shots_per_sec']:.1f} "
            f"shots/s ({r['seconds']:.2f}s after a warm-up batch); launches {launches} "
            f"(the warm-up's included); plain calls {plain}")
        if not ok:
            raise SystemExit(f"[cc_device] {name}: {nf} failures outside 3 sigma of {ref}")
        check_kernels(f"[cc_device] {name}", launches, plain, CC_KERNELS[name])
        res[name] = {"num_failed": nf, "num_flagged": r["num_flagged"], "shots": r["shots"],
                     "seconds": r["seconds"], "shots_per_s": r["shots_per_sec"],
                     "launches": launches}
    return res


def phase_cc_slice(code, synd):
    """``[cc_slice]``: the first ``CC_SLICE_SHOTS`` [[882]] syndromes
    decoded by BPGD (max_step 100) and by GDG's spans form (the cc882-gdg
    row's knobs) on the card and by the plain versions on the CPU, and by
    BPGD's loop form and its spans form with 64-row buckets on the card:
    no shot may differ in error, convergence, iterations or min_pm."""
    from slidingwindowdecoder_torch.harness.code_capacity import PARITY_ROWS, parity_decoder

    first = synd[:CC_SLICE_SHOTS]
    bpgd_kw = {"max_step": 100}
    cases = [
        ("BPGD card vs CPU", "bpgd", bpgd_kw, ("cuda", {}), ("cpu", {})),
        ("BPGD loop vs spans (64-row buckets), card", "bpgd", bpgd_kw,
         ("cuda", {"mode": "loop"}), ("cuda", {"row_bucket": 64})),
        ("GDG spans card vs CPU", "gdg",
         {**PARITY_ROWS["cc882-gdg"][4], "ensemble_mode": "spans"}, ("cuda", {}),
         ("cpu", {})),
    ]
    for label, which, kw, (dev_a, kw_a), (dev_b, kw_b) in cases:
        out = []
        for dev, extra in ((dev_a, kw_a), (dev_b, kw_b)):
            t0 = time.perf_counter()
            r = parity_decoder(code, CC_P, which, {**kw, **extra}, device=dev).decode_batch(first)
            out.append((r, time.perf_counter() - t0))
        (ra, ta), (rb, tb) = out
        differ = np.zeros(len(first), bool)
        for k in ("error", "converged", "iterations", "min_pm"):
            a, b = getattr(ra, k), getattr(rb, k)
            differ |= (a != b).reshape(len(first), -1).any(axis=1)
        log(f"[cc_slice] {label}, {len(first)} shots: converged {int(ra.converged.sum())}, "
            f"shots differing {int(differ.sum())}; {ta:.1f}s and {tb:.1f}s")
        if differ.any():
            raise SystemExit(f"[cc_slice] {label}: {int(differ.sum())} shots differ")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.harness.circuit_level import (
        build_bb_window_experiment,
        gdg_window_factory,
        window_decoder_factory,
    )

    t_all = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    phase_build()
    num_repeat = 12
    _, _, dem, plan = build_bb_window_experiment(144, 0.004, num_repeat, 3, 1)
    log(f"[setup] DEM {dem.chk.shape}, windows {[w.mat.shape for w in plan.windows]}")
    cn = phase_cn(plan)
    cnp = phase_cn_pinned(plan)
    gj = phase_gj(plan)
    t0 = time.perf_counter()
    det, obs, _ = sample_dem_numpy(dem, REF_SHOTS, np.random.default_rng(SEED))
    log(f"[setup] sampled {REF_SHOTS} shots in {time.perf_counter() - t0:.1f}s")
    osd_cs = phase_osd_cs(plan, det)
    span = phase_bp_span(plan, det)
    main_res = phase_path("main", plan, det, obs,
                          window_decoder_factory(False, device="cuda", **FLAGSHIP_KNOBS),
                          num_repeat, (REF_FAILED, REF_SHOTS), REF_FAILED,
                          ("bp_span", "osd_cs_fused"))
    _, _, dem72, plan72 = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    det72, obs72, _ = sample_dem_numpy(dem72, 128, np.random.default_rng(SEED))
    phase_card_vs_cpu("small", plan72, det72, obs72, lambda dev: window_decoder_factory(
        False, max_iter=30, osd_order=2, phase_a_iters=None, phase_b_spans=None,
        device=dev))
    main_res.pop("e_hat")
    log(json.dumps({"main_path": main_res}))
    short_res = phase_path("osd_window", plan, det, obs,
                           window_decoder_factory(True, device="cuda"), num_repeat,
                           (REF_SHORT_FAILED, REF_SHORT_SHOTS), SHORT_FAILED,
                           ("bp_span_pinned", "osd_cs_fused"))
    phase_card_vs_cpu("osd_window_slice", plan, det[:SLICE_SHOTS], obs[:SLICE_SHOTS],
                      lambda dev: window_decoder_factory(True, device=dev))
    phase_card_vs_cpu("osd_window_small", plan72, det72, obs72,
                      lambda dev: window_decoder_factory(True, max_iter=30, osd_order=2,
                                                         device=dev))
    short_res.pop("e_hat")
    log(json.dumps({"osd_window_path": short_res}))

    _, _, gdem, gplan = build_bb_window_experiment(144, GDG_P, num_repeat, 3, 1)
    gdet, gobs, _ = sample_dem_numpy(gdem, GDG_SHOTS, np.random.default_rng(SEED))
    gdg_burst = phase_bp_span_gdg(gplan, gdet, GDG_BUCKET)
    gdg_res = phase_path("gdg", gplan, gdet, gobs,
                         gdg_window_factory(max_iter=8, ensemble_bucket=GDG_BUCKET,
                                            device="cuda"),
                         num_repeat, (REF_GDG_FAILED, REF_GDG_SHOTS), GDG_FAILED,
                         ("bp_span", "bp_span_pinned"))
    gdg_res["ensemble_bucket"] = GDG_BUCKET
    k = GDG_SLICE_SHOTS
    phase_card_vs_cpu("gdg_slice", gplan, gdet[:k], gobs[:k], lambda dev: gdg_window_factory(
        max_iter=8, ensemble_bucket=GDG_SLICE_BUCKET, device=dev))
    phase_card_vs_cpu("gdg_small", plan72, det72, obs72,
                      lambda dev: gdg_window_factory(max_iter=8, device=dev))
    log(json.dumps({"gdg_path": {k: v for k, v in gdg_res.items() if k != "e_hat"}}))
    spans_res = phase_gdg_spans(gplan, gdet, gobs, num_repeat, gdg_res)
    log(json.dumps({"gdg_spans_path": spans_res}))

    from slidingwindowdecoder_torch.harness.code_capacity import parity_code

    code882 = parity_code(882)
    cc_synd = cc_samples(code882)
    phase_osd_882(code882, cc_synd[:CC_OSD_CHECK_SHOTS], gj, osd_cs)
    bpgd_burst = phase_bp_span_bpgd(code882, cc_synd[:CC_SHOTS])
    cc_res = phase_cc_host(code882)
    cc_dev = phase_cc_device(code882)
    phase_cc_slice(code882, cc_synd)
    log(json.dumps({"code_capacity": cc_res, "code_capacity_device": cc_dev}))

    span_src = "slidingwindowdecoder_torch/csrc/bp_span.cu"
    cn_src = "slidingwindowdecoder_torch/csrc/cn_update.cu"
    gj_src = "slidingwindowdecoder_torch/csrc/gauss_jordan.cu"
    by_path = {k: {"main": main_res["launches"][k], "osd_window": short_res["launches"][k],
                   "gdg": gdg_res["launches"][k], "gdg_spans": spans_res["launches"][k],
                   "code_capacity": sum(r["launches"][k] for r in (*cc_res.values(),
                                                                   *cc_dev.values()))}
               for k in main_res["launches"]}
    span["bp_span_pinned"]["gdg_burst"] = gdg_burst
    span["bp_span_pinned"]["bpgd_burst"] = bpgd_burst
    span["bp_span_pinned"]["max_abs_err"] = max(span["bp_span_pinned"]["max_abs_err"],
                                                gdg_burst["max_abs_err"],
                                                bpgd_burst["max_abs_err"])
    kernels = [
        {"name": "bp_span", "route": "cuda", "source": span_src,
         "replaces": "ops/bp_pallas.py:42 (_cn_kernel, JAX package) with the XLA ops "
                     "of ops/bp.py:172 (bp_run's iteration)",
         "launches": sum(by_path["bp_span"].values()), **span["bp_span"]},
        {"name": "bp_span_pinned", "route": "cuda", "source": span_src,
         "replaces": "ops/bp_pallas.py:42 (_cn_kernel with pinned=True, JAX package) with "
                     "the XLA ops of ops/bp.py:172 (masked bp_run's iteration)",
         "launches": sum(by_path["bp_span_pinned"].values()), **span["bp_span_pinned"]},
        {"name": "cn_update", "route": "cuda", "source": cn_src,
         "replaces": "ops/bp_pallas.py:42 (_cn_kernel, JAX package)",
         "launches": sum(by_path["cn_update"].values()), "bound_by": "bytes", **cn},
        {"name": "cn_update_pinned", "route": "cuda", "source": cn_src,
         "replaces": "ops/bp_pallas.py:42 (_cn_kernel with pinned=True, JAX package)",
         "launches": sum(by_path["cn_update_pinned"].values()), "bound_by": "bytes", **cnp},
        {"name": "gauss_jordan_key", "route": "cuda", "source": gj_src,
         "replaces": "ops/gf2_pallas.py:54 (_gj_kernel, JAX package)",
         "launches": sum(by_path["gauss_jordan_key"].values()), **gj},
        {"name": "osd_cs_fused", "route": "cuda", "source": gj_src,
         "replaces": "ops/gf2_pallas.py:54 (_gj_kernel, JAX package) with the XLA "
                     "ops/gf2_solve.py:215 (ordered_gauss_jordan_key) and :522 "
                     "(_osd_sweep_cs_sortless)",
         "launches": sum(by_path["osd_cs_fused"].values()), **osd_cs},
    ]
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
        k.setdefault("library_ms", None)  # no single PyTorch call computes these
    log(f"[total] {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
