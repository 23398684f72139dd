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
   bf16, at the global DEM graph's bf16 blocks [35, 960, B], B in {8192,
   1024}, and at a [[288]] W=4 interior window's f32 blocks [35, 608, B],
   B in {16384, 512}, with forced ties, clipping and padding: bit-exact
   (no path launches kernel A now: it is the CN stage of the per-op loop,
   the plain version the fused kernel's cases are timed beside);
2b. ``[bp4_cn]``: kernel A at BP4's shapes, [6, 448, 2048] ([[882]], a
   bp4 row's batch) and [20, 192, 4096] ([[362]], CAMEL's 4 x 1024 branch
   lanes), f32, against its plain version: bit-exact on every valid edge;
3. the pinned kernel A (masked BP) against its plain version at [35, 224,
   B], B in {512, 16384}, on a [[288]] W=4 window (m_pad 608) and on the
   [[144]] global DEM graph (m_pad 960) at B=1024, f32 and bf16, and on
   the global graph at the shortened global decode's f32 blocks, B in
   {8192, 512}, with ~30 % of the edges and whole checks pinned:
   bit-exact;
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
4c. ``[osd_e]``: OSD-E of order 7 (127 candidates) on a 216x1728 bucket
   of 256 shots: ``gauss_jordan_key`` against the plain elimination on the
   card and on the CPU, then ``osd_decode``'s OSD-E branch (the kernel and
   the dense sweep) on the card against the plain elimination and sweep on
   the CPU: solution, OSD-0, inconsistency and the bits of min_pm equal;
   then ``BPOSD`` and ``OSDWindow`` with ``osd_method="osd_e"`` on 64
   [[72]] window syndromes, card vs CPU, no shot differing;
5. the fused BP kernel (``bp_span.cu``: a whole ``bp_run`` call in one
   launch) on the card against the plain loop on the CPU at every shape
   the paths give it, on window-0 syndromes of the seed-2024 samples: the
   whole-batch pre-BP (masked f32, B=16384, 8 iterations) and phase A
   (unmasked bf16, B=16384, 16 iterations), held on their first 256
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
   256 of those shots, at full width (no shot may differ), and a small
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
   reference's 400/5000); then its first 32 shots at full width, and the
   small input, each on the card and by the plain versions on the CPU (no
   shot may differ);
9. ``[gdg_spans]``: the GDG path again with the span-compacted ensemble
   (``ensemble_mode="spans"``): exactly ``GDG_FAILED`` failures, and every
   correction and flag equal to the host-stepped form's, with its shots/s
   beside that form's and the columns stepped in each span as a share of
   the ensemble's columns;
9b. ``[gdg_bf16]``: the GDG path at the JAX package's GDG parity knobs
   (bf16 messages and history ring, the spans form, 512-shot ensemble
   buckets) over the same 8192 shots: exactly ``GDG_BF16_FAILED`` failures
   (and within 3 sigma of 400/5000), launching only ``bp_span`` and
   ``bp_span_pinned`` with the bf16 ring, and its first 32 shots on the
   card and by the plain versions on the CPU (no shot may differ);
   ``[gdg_serial]``: the serial work queue (``GDG(multi_thread=False)``) on
   window 0's PCM over 256 of its syndromes, on the card (``bp_span`` and
   ``bp_span_pinned`` only) and on the CPU, no shot differing;
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
11. ``[global]``: ``global_decoder`` on the whole [[144]] DEM (936x8784) at
   p=0.004, 16384 shots from seed 2024, BP+OSD-CS-10 (bf16, the bench
   knobs), held to its own count and within 3 sigma of the reference's
   76/10000, and the shortened ``OSDWindow``, held to its own count (its
   verdicts against the reference's 90/10000 and the JAX package's
   98/16384 printed), and 8192 shots with BP+OSD-0 (its own count, no shot
   flagged), with the launch counts read around it (the fused BP kernel's
   wide route, ``bp_span_wide`` or ``bp_span_wide_pinned``, and the cluster
   route of ``osd_cs_fused`` or ``gauss_jordan_key``); ``[sw_wide]``: the
   [[144]] W=4 and W=5 windows at
   p=0.004 and the [[288,12,18]] W=4 windows (r=6, p=0.005), BP+OSD-CS-10 at
   the default knobs, 16384 shots each, each held to its own count and
   within 3 sigma of 131, 107 and 70 /10000 ([[288]] W=4 launching
   ``bp_span`` on its edge windows and ``bp_span_wide`` on its interior
   ones); then the fused BP kernel on the first call of each window shape,
   batch and span it took there, on the route it took (and a [[288]] edge
   window's 48-iteration span also on the wide route), against the plain loop on
   the CPU over 32 shots, and kernel B's fused entry point on the first
   OSD bucket of each window shape, against the plain versions on the
   card, bit-exact; ``[bp_span_wide]``: the wide route on the first call
   of each batch and span of the global decode's BP+OSD-CS form (bf16:
   phase A at 8192 shots, the two phase-B spans at 1024) and of its
   shortened form (pinned f32: the pre-BP chunk and the first post-BP
   bucket), against the plain loop on the CPU over 32 shots, bit-exact,
   each timed beside the per-op loop with kernel A on the card and its
   bound;
   ``[gj_cluster]``: kernel B's cluster route (both entry points) against
   the plain elimination and sweep, on the card over the bucket and on the
   CPU over its first shots, bit-exact: tie keys at 216x1728 forced to 4
   blocks, and the first OSD buckets of a [[288]] W=4 interior window
   (576x4896, 2 blocks) and of the global decode (936x8784, 8 blocks), with
   times and bounds beside the times before the redesign, the measured
   split (steps, rounds and dead rounds a shot, waves of clusters, time a
   round, the sweep's share) and, at 576x4896, the fused launch on
   clusters of 4 and 8; ``[global_slice]``: 32 global shots on the card and
   on the CPU, no shot differing;
11b. ``[gdg_wide]``: gdg-last-osd ([[288,12,18]] W=4, r=6, p=0.005, the
   JAX rows' knobs: 47 branches, 60 steps, bf16) through
   ``sliding_window_gdg`` on 512 seed-2024 shots: exactly
   ``GDG_WIDE_FAILED`` failures and ``GDG_WIDE_OSD_FAILED`` with the
   last-window BP+OSD-CS-10 (each within 3 sigma of 136 and 85 /20000),
   launching ``bp_span``, ``bp_span_pinned`` with the bf16 ring and the
   cluster route of ``osd_cs_fused`` only; the fused BP kernel on the first
   pre-BP call of each window shape (576x4896 and 576x4752, unmasked bf16,
   512 shots, 16 iterations, one shot a block) against the plain loop on
   the CPU over 32 shots, bit-exact; then 16 shots on the card and by the
   plain versions on the CPU (no shot may differ);
   ``[bp_span_bf16_ring]``: the fused kernel with a bf16 history ring on the
   card against the plain loop on the CPU, bit-exact (ring, error, done,
   iterations, ``synd_hat``), on the GDG bursts captured at depth 4 in
   ``[gdg_bf16]`` and ``[gdg_wide]`` at every window width (216x1656 and
   216x1728; 576x4896 and 576x4752, one shot a block), and on an unmasked
   call (the window-0 pre-BP, 8192 shots), each timed beside the same
   input with an f32 ring, with both bounds;
11c. ``[bp4]``: bp4-osdcs (BP4 + OSD-CS-10 per basis on [[882]], p = 0.1)
   and camel-362 (CAMEL on [[362]], p = 0.02), ``[phenom]``: phenom-osd and
   phenom-gdg ([hx | I] of [[288]], p = 0.03, p_synd = 1e-3, BP+OSD-CS-10
   and GDG), ``[shyps]``: shyps-window and shyps-global (r = 3, p = 0.001,
   4 rounds, BP+OSD-CS over the weight-1 candidates): each row through
   ``run_row`` of ``tools/torch_validate_depolarizing.py`` on 4096-16384
   shots from seed 2024,
   held to the port's own count (``ROW_FORMS``) and within 3 sigma of the
   reference's rate, with the launch counts read around it (``cn_update``
   with ``osd_cs_fused`` for BP4+OSD, ``cn_update`` alone for CAMEL,
   ``bp_span`` with ``osd_cs_fused`` or ``bp_span_pinned`` for the rest);
   then the first 64 shots of every one of these rows on the card and by
   the plain versions on the CPU (no shot may differ; phenom-gdg's CPU
   half, GDG's pinned bursts on the 144x432 PCM, ~16 s on one thread);
12. the CPU halves of every card-vs-CPU phase (``run_cpu_halves``);
13. a ``{"kernels": [...]}`` line, the card's name and power limit, and the
   final ``{"ok": true, ...}`` line.

The card-vs-CPU phases run their card halves in place and defer their CPU
halves (the 256 shortened, 32 GDG, 32 bf16 GDG and 16 [[288]] GDG shots,
the 256 serial syndromes, the 32 global and 256 [[882]] shots, the small
[[72]] inputs, the 64-shot row slices) to step 12, after every timed phase, so that no rate or
time the script reports is read under their load; they run there in eight
single-threaded worker processes, which end on any exit.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
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
SLICE_SHOTS = 256
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
GDG_SLICE_SHOTS, GDG_SLICE_BUCKET = 32, 32
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
# the whole-block decode (``global_decoder``) of the [[144]] DEM (936x8784)
# at p=0.004 from seed 2024 in 8192-shot chunks, by form: its arguments,
# shots, the rates its count is compared with (failed, shots), whether it
# must lie within 3 sigma of the first, the port's own count at seed 2024
# (its first run on the card) and the kernels it may launch (BP on the
# fused kernel's wide route: the graph's tables and messages do not fit one
# block together; OSD on kernel B's cluster route). BP+OSD-CS is held to the reference's rate
# (docs/PARITY.md, IBM.ipynb cell 3). The shortened form is held to its
# exact count alone: it lies outside 3 sigma of the reference's 90/10000
# (IBM.ipynb cell 5) at seeds 2024 and 7 (78 and 84 of 16384, the port's
# runs on the card, PERF.md), and both verdicts are printed, against the
# reference and against the JAX package's 98/16384 (docs/PARITY.md, seed
# 7). The OSD-0 form (the elimination alone, no reference rate) must leave
# no syndrome unmatched.
GLOBAL_FORMS = {
    "bposd": ({}, 16384, {"reference": (76, 10000)}, True, 152,
              ("bp_span_wide", "osd_cs_fused_cluster")),
    "shortened": ({"shorten": True}, 16384,
                  {"reference": (90, 10000), "JAX package, seed 7": (98, 16384)}, False, 78,
                  ("bp_span_wide_pinned", "osd_cs_fused_cluster")),
    "osd0": ({"osd_method": "osd_0"}, 8192, {}, False, 151,
             ("bp_span_wide", "gauss_jordan_key_cluster")),
}
# the wide sliding windows, BP+OSD-CS-10 at the default knobs (f32), 16384
# shots from seed 2024 each: (N, p, rounds, W, reference (failed, shots),
# the port's own count (its first run on the card), kernels); [[144]] W=4/5
# (288x2376/2448, 360x3096/3168) fit both fused kernels; [[288]] W=4
# (576x4752/4896) runs its interior windows' f32 BP on the fused kernel's
# wide route (its edge windows' on the shared-table route) and all its OSD
# on the cluster route
SW_WIDE_SHOTS = 16384
SW_WIDE = {
    "144-w4": (144, 0.004, 12, 4, (131, 10000), 196, ("bp_span", "osd_cs_fused")),
    "144-w5": (144, 0.004, 12, 5, (107, 10000), 167, ("bp_span", "osd_cs_fused")),
    "288-w4": (288, 0.005, 6, 4, (70, 10000), 91,
               ("bp_span", "bp_span_wide", "osd_cs_fused_cluster")),
}
# shots of each recorded [sw_wide] BP call that the plain loop also takes
# on the machine's CPU
SW_WIDE_CPU_SHOTS = 32
# global shots decoded on the card and by the plain versions on the CPU
GLOBAL_SLICE_SHOTS = 32
# shots of each [gj_cluster] bucket that the plain versions also take on
# the machine's CPU
GJ_CLUSTER_CPU_SHOTS = 32


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
    """Build the three kernel sources (one ``nvcc`` each, started together)
    and, beside them, the probe copy of ``gauss_jordan.cu`` that
    ``[gj_cluster]`` times (``tools/torch_probe_gj_cluster.py``); waits for
    all four, so no build competes with a timed phase, and returns the
    probe build."""
    from concurrent.futures import ThreadPoolExecutor

    from slidingwindowdecoder_torch.ops import bp_cuda, gf2_cuda
    from slidingwindowdecoder_torch.utils import cuda_build

    sys.path.insert(0, str(cuda_build.CSRC.parents[1] / "tools"))
    import torch_probe_gj_cluster as probe_tool

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        probe = pool.submit(probe_tool.build_probe)
        secs = cuda_build.build([bp_cuda.SOURCE, bp_cuda.SPAN_SOURCE, gf2_cuda.SOURCE])
        probe = probe.result()
    log(f"[build] {time.perf_counter() - t0:.1f}s wall (the probe copy's included); per "
        f"source {secs}")
    for src, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {src}: {line.strip()}")
    return probe


@functools.cache
def wide_pcms():
    """(the [[144]] global DEM's check matrix (936x8784, m_pad 960), a
    [[288]] W=4 interior window's (576x4896, m_pad 608)): the graphs that
    BP runs on kernel A through ``bp_loop``."""
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment

    _, _, dem144, _ = build_bb_window_experiment(144, 0.004, 12, 3, 1)
    _, _, _, plan288 = build_bb_window_experiment(288, 0.005, 6, 4, 1)
    return dem144.chk, plan288.windows[1].mat


def cn_bound_bytes(valid, m: int, B: int, itemsize: int) -> int:
    """The bytes a check-node update of ``m`` checks at ``B`` columns must
    move: the messages of the valid edges read and written, the checks'
    int32 parities and their rows of the valid mask (the padding rows up to
    ``m_pad`` and the invalid slots count nothing)."""
    return 2 * int(valid.sum()) * B * itemsize + m * B * 4 + valid.shape[0] * m


def phase_cn(plan):
    """Kernel A against its plain version, bit-exact, on random messages
    with ties, equal values and zeros, at the shapes of the unmasked BP:
    the flagship window (phase A at 16384 shots, phase-B buckets of 1024,
    f32 and bf16), the global DEM graph in bf16 (phase A at 8192 shots, the
    chunk; phase-B buckets of 1024) and a [[288]] W=4 interior window in
    f32 (phase A at 16384 shots, phase-B buckets of 512). The kernels line
    keeps the flagship phase-A case; the others go under their paths."""
    import torch

    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops.bp import _cn_update_sm
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update

    f32, bf16 = torch.float32, torch.bfloat16
    win, glob, w288 = plan.windows[1].mat, *wide_pcms()
    cases = [(None, win, B, dt) for B in (1024, 16384) for dt in (f32, bf16)] + [
        ("global_phase_a", glob, 8192, bf16), ("global_phase_b", glob, 1024, bf16),
        ("sw_288_w4_phase_a", w288, 16384, f32), ("sw_288_w4_phase_b", w288, 512, f32)]
    gen = torch.Generator(device="cuda").manual_seed(7)
    result = {"max_abs_err": 0.0}
    for name, H, B, dtype in cases:
        g = compile_graph(H)
        valid = graph_tensors(g, "cuda")["cn_valid_sm"]
        dc, m_pad = g.dc, g.m_pad
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
        nbytes = cn_bound_bytes(valid, H.shape[0], B, mv.element_size())
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shape = f"[{dc},{m_pad},{B}] {str(dtype)[6:]}"
        log(f"[cn] {H.shape[0]}x{H.shape[1]} {shape}: bit-exact={same} "
            f"max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms (bytes {nbytes})")
        if not same:
            raise SystemExit(f"kernel A disagrees with its plain version at {shape}")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        case = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "shape": shape}
        if name:
            result[name] = case
        elif B == 16384 and dtype == bf16:  # phase A of the main path
            result.update(case)
        del mv, parity, out, ref
    cn_update.launches = 0
    return result


def phase_cn_pinned(plan):
    """The pinned kernel against its plain version at the shapes of the
    masked BP: the flagship window (pre-BP at 16384 shots, post-BP buckets
    of 512), a [[288]] W=4 window and the [[144]] global DEM graph at 1024
    shots (the shapes where the TPU kernel faulted its worker), and the
    global graph in f32 at the shortened global decode's pre-BP chunk (8192
    shots) and post-BP buckets (512)."""
    import torch

    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops.bp import PIN, _cn_update_sm
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update

    glob, w288 = wide_pcms()
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(H, B, dt) for H, B in ((plan.windows[1].mat, 512), (plan.windows[1].mat, 16384),
                                     (w288, 1024), (glob, 1024)) for dt in (f32, bf16)] + [
        (glob, 8192, f32), (glob, 512, f32)]
    gen = torch.Generator(device="cuda").manual_seed(13)
    result = {"max_abs_err": 0.0}
    for H, B, dtype in cases:
        g = compile_graph(H)
        valid = graph_tensors(g, "cuda")["cn_valid_sm"]
        dc, m_pad = g.dc, g.m_pad
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
        nbytes = cn_bound_bytes(valid, H.shape[0], B, mv.element_size())
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shape = f"[{dc},{m_pad},{B}] {str(dtype)[6:]}"
        log(f"[cn_pinned] {H.shape[0]}x{H.shape[1]} {shape}: bit-exact={same} "
            f"max_abs_err={err} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms (bytes {nbytes})")
        if not same:
            raise SystemExit(f"the pinned kernel disagrees with its plain version at {shape}")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        case = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "shape": shape}
        if m_pad == 224 and B == 512 and dtype == f32:  # post-BP bucket
            result.update(case)
        elif m_pad == 960 and dtype == f32 and B != 1024:  # the shortened global decode
            result["global_pre_bp" if B == 8192 else "global_post_bp"] = case
        del mv, parity, out, ref
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
# kernel B's cluster route before its redesign (the first cluster design,
# PERF.md): the fused launch and the elimination alone on the first OSD
# bucket of each path shape, timed by tools/torch_probe_gj_cluster.py on an
# H100 80GB HBM3 at 700 W
GJ_CLUSTER_BEFORE_MS = {"936x8784": {"fused": 78.114, "alone": 66.893},
                        "576x4896": {"fused": 17.609, "alone": 14.759}}


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


def _gj_shots(gj, k: int):
    """The first ``k`` shots of an elimination's result dict (its packed
    state is shot-minor)."""
    return {key: v[..., :k] if key == "reduced_wm" else v[:k] for key, v in gj.items()}


def _gj_case(label, Hw, synd, key, *, m: int, n: int, rank: int, cluster_blocks=None,
             cpu_ref=None, reps: int = 20, plain_reps: int = 2, **_):
    """``gauss_jordan_key`` on the card (the route its shape takes, or the
    cluster route with ``cluster_blocks``) against ``ordered_gauss_jordan_key``
    on the same inputs, every output bit-exact, and on its first shots
    against the plain version's result on the CPU (``cpu_ref``); then its
    time, the plain version's and the bound."""
    import torch

    from slidingwindowdecoder_torch.ops import gf2_cuda
    from slidingwindowdecoder_torch.ops.gf2_cuda import gauss_jordan_key
    from slidingwindowdecoder_torch.ops.gf2_solve import ordered_gauss_jordan_key

    W, B = Hw.shape[1], synd.shape[0]
    C = gf2_cuda.gj_route(m, n, W, False, cluster_blocks)
    counter = "cluster_launches" if C else "launches"
    before = getattr(gauss_jordan_key, counter)
    out = gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank, cluster_blocks=cluster_blocks)
    torch.cuda.synchronize()
    if getattr(gauss_jordan_key, counter) != before + 1:
        raise SystemExit(f"kernel B ({'cluster' if C else 'single-block'} route) was not "
                         f"launched")
    ref = ordered_gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank)
    bad = [k for k in ref if not torch.equal(out[k], ref[k])]
    if cpu_ref is not None:
        head = _gj_shots(out, cpu_ref["shots"])
        bad += [f"{k} (CPU)" for k in ref if not torch.equal(head[k].cpu(), cpu_ref["gj"][k])]
    err = max(float((out[k].double() - ref[k].double()).abs().max()) for k in ref)
    ms = cuda_time_ms(lambda: gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank,
                                               cluster_blocks=cluster_blocks), reps)
    plain_ms = cuda_time_ms(
        lambda: ordered_gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank), plain_reps)
    xor_rows = int(ordered_gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank,
                                            count_xor=True)["xor_rows"].sum())
    ops = _gj_ops(m, n, W, rank, B, xor_rows)
    nbytes = Hw.numel() * 4 + synd.numel() + key.numel() * 4 + B * (
        m * (W + 1) * 4 + 2 * rank * 4 + 1)
    ops_ms, bytes_ms = ops / INT32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    n_incons = int(out["inconsistent"].sum())
    tag = "gj_cluster" if C else "gj"
    route = f"cluster of {C} blocks" if C else "one block"
    cpu = f", first {cpu_ref['shots']} shots also against the CPU" if cpu_ref else ""
    log(f"[{tag}] {label} rank {rank} B={B} ({route}{cpu}): bit-exact={not bad} "
        f"max_abs_err={err} inconsistent {n_incons}/{B}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms (ops {ops}, {xor_rows} rows XORed -> "
        f"{ops_ms:.5f} ms, bytes {nbytes} -> {bytes_ms:.5f} ms)")
    if bad:
        raise SystemExit(f"[{tag}] {label}: kernel B disagrees with its plain version on {bad}")
    gauss_jordan_key.launches = gauss_jordan_key.cluster_launches = 0
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "shape": f"{m}x{n} B={B}" + (f", C={C}" if C else "")}


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


def _clone(x):
    return x.clone() if hasattr(x, "clone") else x


@contextlib.contextmanager
def first_calls(module, name: str, key, store: dict):
    """Record in ``store``, under ``key(*args, **kwargs)``, the arguments of
    the first call of ``module.name`` with each key while the block runs
    (a key of None is not recorded). Tensors are cloned, since the decode
    may go on writing them; no kernel runs for it."""
    orig = getattr(module, name)

    def first(*a, **k):
        got = key(*a, **k)
        if got is not None and got not in store:
            store[got] = (tuple(_clone(x) for x in a), {x: _clone(v) for x, v in k.items()})
        return orig(*a, **k)

    setattr(module, name, first)
    try:
        yield
    finally:
        setattr(module, name, orig)


def osd_shape(*_, m, n, **__):
    """``first_calls`` key of an ``osd_decode`` call: its PCM's shape."""
    return m, n


def _first_osd_bucket(module, decoder, synd):
    """The arguments of the first ``osd_decode`` call of ``decoder`` (whose
    module is ``module``) in one ``core`` call on ``synd``."""
    seen = {}
    with first_calls(module, "osd_decode", osd_shape, seen):
        decoder.core(synd)
    return seen[(decoder.m, decoder.n)]


def _osd_cs_case(label, Hw, s, key, llr, *, m: int, n: int, rank: int, meta: dict,
                 cluster_blocks=None, cpu_ref=None, reps: int = 20, plain_reps: int = 2, **_):
    """``osd_cs_fused`` on the card (the route its shape takes, or the
    cluster route with ``cluster_blocks``) against the plain elimination
    and sweep on the same inputs, and on its first shots against their
    result on the CPU (``cpu_ref``): solution, OSD-0, inconsistency and the
    bits of min_pm equal; then its time beside the standalone
    elimination's, kernel B's before the fused design, the plain version's
    and the bound."""
    import torch

    from slidingwindowdecoder_torch.ops import gf2_cuda
    from slidingwindowdecoder_torch.ops.gf2_cuda import gauss_jordan_key, osd_cs_fused
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        _osd_sweep_cs_sortless,
        ordered_gauss_jordan_key,
    )

    W, Bc = Hw.shape[1], s.shape[0]
    pi, pj = (torch.as_tensor(meta[k], dtype=torch.int32, device="cuda")
              for k in ("pair_i", "pair_j"))
    ow = int(meta["order_w"])
    C = gf2_cuda.gj_route(m, n, W, True, cluster_blocks)
    counter = "cluster_launches" if C else "launches"

    def fused():
        return osd_cs_fused(Hw, s, key, llr, pi, pj, m=m, n=n, rank=rank, order_w=ow,
                            cluster_blocks=cluster_blocks)

    def plain(count_xor=False):
        gj = ordered_gauss_jordan_key(Hw, s, key, m=m, n=n, rank=rank, count_xor=count_xor)
        return gj, _osd_sweep_cs_sortless(gj, key, llr, pi, pj, order_w=ow)

    before = getattr(osd_cs_fused, counter)
    out = fused()
    torch.cuda.synchronize()
    if getattr(osd_cs_fused, counter) != before + 1:
        raise SystemExit(f"the fused OSD-CS kernel ({'cluster' if C else 'single-block'} "
                         f"route) was not launched")
    gj, (sol, min_pm) = plain(count_xor=True)
    pairs = {"solution": (out["solution"], sol), "osd0": (out["osd0"], gj["osd0"]),
             "inconsistent": (out["inconsistent"], gj["inconsistent"]),
             "min_pm": (out["min_pm"].view(torch.int32), min_pm.view(torch.int32))}
    if cpu_ref is not None:
        k = cpu_ref["shots"]
        pairs.update({
            "solution (CPU)": (out["solution"][:k].cpu(), cpu_ref["solution"]),
            "osd0 (CPU)": (out["osd0"][:k].cpu(), cpu_ref["gj"]["osd0"]),
            "inconsistent (CPU)": (out["inconsistent"][:k].cpu(),
                                   cpu_ref["gj"]["inconsistent"]),
            "min_pm (CPU)": (out["min_pm"][:k].cpu().view(torch.int32),
                             cpu_ref["min_pm"].view(torch.int32))})
    bad = [k for k, (x, y) in pairs.items() if not torch.equal(x, y)]
    err = max(float((out[k].double() - y.double()).abs().max())
              for k, y in (("solution", sol), ("osd0", gj["osd0"]), ("min_pm", min_pm)))
    ms = cuda_time_ms(fused, reps)
    gj_ms = cuda_time_ms(lambda: gauss_jordan_key(Hw, s, key, m=m, n=n, rank=rank,
                                                  cluster_blocks=cluster_blocks), reps)
    plain_ms = cuda_time_ms(plain, plain_reps)
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
    tag = "osd_cs_cluster" if C else "osd_cs"
    route = f"cluster of {C} blocks" if C else "one block"
    cpu = f", first {cpu_ref['shots']} shots also against the CPU" if cpu_ref else ""
    log(f"[{tag}] {label} B={Bc} ({route}{cpu}): bit-exact={not bad} max_abs_err={err}; "
        f"{n_cand} shots take a candidate, {int(gj['inconsistent'].sum())} inconsistent; "
        f"fused {ms:.4f} ms, elimination alone {gj_ms:.4f} ms, before {GJ_BEFORE_MS} ms "
        f"(kernel B at 216x1728), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms (int32 "
        f"{int_ops} with {xor_rows} rows XORed, float32 {f32_ops}, float64 {f64_adds} "
        f"-> {ops_ms:.5f} ms, bytes {nbytes} -> {bytes_ms:.5f} ms)")
    if bad:
        raise SystemExit(f"[{tag}] {label}: the fused kernel disagrees with its plain "
                         f"version on {bad}")
    for f in (gauss_jordan_key, osd_cs_fused):
        f.launches = f.cluster_launches = 0
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "elimination_ms": gj_ms, "shape": f"{m}x{n} B={Bc}" + (f", C={C}" if C else "")}


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


def _span_case(label, args, kw, cpu_garr, reps: int, cpu_shots: int | None = None,
               ring_times: bool = True, route: str | None = None):
    """One ``bp_span`` input on the card (on the table route ``span_route``
    names, or on ``route``) against the plain loop on the CPU
    (``_span_diff``; over the first ``cpu_shots`` shots where given: BP is
    per shot), then its time, the per-op CUDA loop's time (its CN stage
    kernel A) and the bound (the ring's writes counted at its element
    size); with ``ring_times`` also its time with the history ring written
    at every iteration and at none; with a bf16 ring also its time and
    bound with the same input's ring in f32."""
    import torch

    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.ops.bp import bp_loop

    garr, mv = args[0], args[1]
    masked = kw["masked"]
    B, n, dc, m_pad, dv = mv.shape[2], garr["n"], garr["dc"], garr["m_pad"], garr["dv"]
    # the card's calls (the CPU's run bp_span's plain loop)
    span = bp_cuda.bp_span if route is None else functools.partial(bp_cuda._launch_span, route)
    route = route or bp_cuda.span_route(garr, B, mv.dtype)
    counter = f"{'pinned_' if masked else ''}{'wide_' if route == bp_cuda.WIDE else ''}launches"

    def inputs(dev, k=None):  # the history ring is written in place: a copy each
        a = [t.to(dev) if torch.is_tensor(t) else t for t in args[1:]]
        if k is not None:  # the first k shots
            mv_, prior, parity, synd_t, vn, hist, error, done, iters = a
            a = [x if x is None else x.contiguous() for x in (
                mv_[:, :, :k], prior, parity[:, :k], synd_t[:, :k],
                None if vn is None else vn[:k], hist[:, :, :k], error[:k], done[:k],
                iters[:k])]
        a[5] = a[5].clone()
        return (cpu_garr if dev == "cpu" else garr, *a)

    card_args = inputs("cuda")
    before = getattr(bp_cuda.bp_span, counter)
    out = [x.cpu() for x in span(*card_args, **kw)]
    torch.cuda.synchronize()
    if getattr(bp_cuda.bp_span, counter) != before + 1:
        raise SystemExit(f"[bp_span] {label}: the kernel was not launched once")
    t0 = time.perf_counter()
    ref = bp_cuda.bp_span(*inputs("cpu", cpu_shots), **kw)  # CPU: the plain loop
    cpu_s = time.perf_counter() - t0
    k = B if cpu_shots is None else cpu_shots
    head = [out[0][:, :, :k], out[1][:, :, :k], *(x[:k] for x in out[2:5]),
            *(x[:, :k] for x in out[5:])]
    err = _span_diff(label if k == B else f"{label}, first {k} shots", head, ref)

    ms = cuda_time_ms(lambda: span(*card_args, **kw), reps)
    plain_ms = cuda_time_ms(lambda: bp_loop(*card_args, **kw), 2)  # per-op loop
    ran = out[4] - args[9].cpu()  # iterations each shot ran in this call
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
    ring_t = args[6].element_size()
    nbytes = live * (2 * dc * m_pad * t + 8 * m_pad + 2 * n) + ring_t * hist_writes
    # all at the float32 rate, though the sign counts run at the integer one
    ops_ms, bytes_ms = ops / FP32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    # shared-memory traffic of one shot-iteration, from the code: CN two
    # reads and a write per edge; the VN gather with its indices, the
    # prior and the rounded posterior; the edge stage's index, posterior,
    # message read and write; degrees, sign seeds and syndrome per check
    smem = shot_iters * (edges * (6 * t + 2) + n * dv * (t + 2) + n * (4 + t) + 6 * m_pad)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S = bp_cuda.shots_per_block(garr, B, mv.dtype, sms, route)
    log(f"[bp_span] {label} ({route} route): {live} of {B} rows not done at entry, {shot_iters} "
        f"shot-iterations, longest {longest}; kernel "
        f"{ms:.4f} ms ({ms / max(longest, 1):.5f} ms per iteration, {S} shots x "
        f"{bp_cuda.MAX_THREADS // S * S} threads per block, {-(-B // S)} blocks, "
        f"{bp_cuda.span_smem_bytes(garr, mv.dtype, S, route)} B shared), per-op loop {plain_ms:.4f} "
        f"ms, bound {max(ops_ms, bytes_ms):.5f} ms (ops {ops} -> {ops_ms:.5f} ms, bytes "
        f"{nbytes} -> {bytes_ms:.5f} ms), shared memory {smem / ms / 1e9:.1f} TB/s; CPU "
        f"plain {cpu_s:.1f}s")
    for hist_from in (0, kw["num_iter"]) if ring_times else ():  # always, or never
        hist_ms = cuda_time_ms(lambda: span(*card_args, **{**kw, "hist_from": hist_from}), reps)
        log(f"[bp_span] {label}: history from iteration {hist_from} -> {hist_ms:.4f} ms")
    res = {"table_route": route, "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "max_abs_err": err,
           "shape": f"[{dc},{m_pad},{B}] {str(mv.dtype)[6:]}, {longest} iterations, "
                    f"{str(args[6].dtype)[6:]} ring"}
    if ring_t == 2:  # the same input with an f32 ring, timed in turns: bf16 f32 bf16 f32
        f32_args = (*card_args[:6], card_args[6].float(), *card_args[7:])
        turns = {"bf16": [ms], "f32": []}
        for ring, a in (("f32", f32_args), ("bf16", card_args), ("f32", f32_args)):
            turns[ring].append(cuda_time_ms(lambda: span(*a, **kw), reps))
        ms, f32_ms = (sum(turns[r]) / 2 for r in ("bf16", "f32"))
        f32_bytes_ms = (nbytes + 2 * hist_writes) / HBM_BYTES_PER_S * 1e3
        res.update(ms=ms, f32_ring_ms=f32_ms, f32_ring_bound_ms=max(ops_ms, f32_bytes_ms))
        log(f"[bp_span] {label}: in turns, bf16 ring {turns['bf16']} ms, f32 ring "
            f"{turns['f32']} ms: {ms:.4f} against {f32_ms:.4f} ms (bounds "
            f"{max(ops_ms, bytes_ms):.5f} and {max(ops_ms, f32_bytes_ms):.5f} ms, bytes {nbytes} "
            f"and {nbytes + 2 * hist_writes})")
    return res


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
    bp_cuda.bp_span.bf16_ring_launches = bp_cuda.bp_span.pinned_bf16_ring_launches = 0
    bp_cuda.bp_span.wide_launches = bp_cuda.bp_span.pinned_wide_launches = 0
    for k in (gf2_cuda.gauss_jordan_key, gf2_cuda.osd_cs_fused):
        k.launches = k.cluster_launches = k.plain_calls = 0


def read_counts():
    """(launches by kernel, plain calls by wrapper) since ``reset_counts``;
    ``bp_span`` / ``bp_span_pinned`` count the fused kernel's shared-table
    route, ``bp_span_wide`` / ``bp_span_wide_pinned`` its wide route;
    ``bp_span_bf16_ring`` and ``bp_span_pinned_bf16_ring`` count the
    unmasked and the masked launches of either route that took a bf16
    history ring."""
    from slidingwindowdecoder_torch.ops import bp_cuda, gf2_cuda

    cn, span = bp_cuda.cn_update, bp_cuda.bp_span
    gj, osd = gf2_cuda.gauss_jordan_key, gf2_cuda.osd_cs_fused
    launches = {"bp_span": span.launches, "bp_span_pinned": span.pinned_launches,
                "bp_span_bf16_ring": span.bf16_ring_launches,
                "bp_span_pinned_bf16_ring": span.pinned_bf16_ring_launches,
                "bp_span_wide": span.wide_launches,
                "bp_span_wide_pinned": span.pinned_wide_launches,
                "cn_update": cn.launches,
                "cn_update_pinned": cn.pinned_launches,
                "gauss_jordan_key": gj.launches, "osd_cs_fused": osd.launches,
                "gauss_jordan_key_cluster": gj.cluster_launches,
                "osd_cs_fused_cluster": osd.cluster_launches}
    plain = {"bp_span": span.plain_calls, "cn_update": cn.plain_calls,
             "gauss_jordan_key": gj.plain_calls, "osd_cs_fused": osd.plain_calls}
    return launches, plain


def check_kernels(name, launches, plain, kernels):
    """Every kernel in ``kernels`` launched, no other one, no plain call."""
    ran = {k for k, v in launches.items() if v}
    if ran != set(kernels) or any(plain.values()):
        raise SystemExit(f"{name} did not run on its kernels {kernels}: {launches} {plain}")


def phase_path(name, plan, det, obs, factory, num_repeat: int, ref, exact, kernels):
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


def window_decode(plan, det, obs, factory, dev):
    """(corrections as numpy, failures, seconds) of ``det`` decoded window
    by window with ``factory`` on ``dev``."""
    from slidingwindowdecoder_torch.windows.pipeline import (
        decode_sliding_window,
        evaluate_logical_errors,
    )

    t0 = time.perf_counter()
    out = decode_sliding_window(plan, det, factory, device=dev, verbose=False)
    ev = evaluate_logical_errors(plan, det, obs, out["total_e_hat"], device=dev)
    return out["total_e_hat"].cpu().numpy(), ev["num_failed"], time.perf_counter() - t0


def phase_card_vs_cpu(name, exp, plan, det, obs, kind: str, kw: dict):
    """Decode ``det`` window by window with ``window_factory(kind, kw)`` on
    the card now; return the same decode by the plain versions on the CPU
    as a deferred CPU half (``run_cpu_halves``) in ``CPU_PIECES`` pieces of
    consecutive shots (a shot decodes alike in any batch; each worker
    builds its plan from ``exp``, the experiment of ``plan``) with its
    comparison. BP, the kernels and the plain versions' f32 sums are
    bit-exact between the two devices, so the failure counts must be
    equal and no shot may differ."""
    card = window_decode(plan, det, obs, window_factory(kind, kw, "cuda"), "cuda")
    pieces = np.array_split(np.arange(det.shape[0]), CPU_PIECES)

    def compare(refs):
        e_hat, failed = np.concatenate([r[0] for r in refs]), sum(r[1] for r in refs)
        diff = int((card[0] != e_hat).any(axis=1).sum())
        log(f"[{name}] card vs CPU plain over {det.shape[0]} shots: failed {card[1]} vs "
            f"{failed}, shots differing {diff}; {card[2]:.1f}s card, "
            f"{sum(r[2] for r in refs):.1f}s CPU in {len(refs)} pieces")
        if card[1] != failed or diff:
            raise SystemExit(f"{name}: the card disagrees with the CPU plain path")

    return name, cpu_window_decode, [(exp, det[i], obs[i], kind, kw) for i in pieces], compare


def results_differ(a, b, shots: int):
    """Per shot, whether two ``DecodeResult``s differ in error,
    convergence, iterations or min_pm."""
    differ = np.zeros(shots, bool)
    for k in ("error", "converged", "iterations", "min_pm"):
        differ |= (getattr(a, k) != getattr(b, k)).reshape(shots, -1).any(axis=1)
    return differ


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


def phase_global(captured: dict, bp_calls: dict):
    """``[global]``: ``global_decoder`` on the whole [[144]] DEM from seed
    2024 in each of ``GLOBAL_FORMS``, each with the launch counts set to 0
    just before and read just after: its failures equal to its own count,
    within 3 sigma of the first rate where the form is held to it, no shot
    flagged where no rate is given, only its kernels launched and no plain
    call. The 3-sigma verdict against each rate is printed. The first OSD
    bucket of the BP+OSD-CS form goes into ``captured`` (under its shape,
    936x8784), and the first ``bp_run`` call of each batch and span of the
    BP+OSD-CS and shortened forms into ``bp_calls`` (under the form's name,
    then ``fused_bp_call``'s key) for ``[bp_span_wide]``."""
    import torch

    from slidingwindowdecoder_torch.decoders import bposd, osd_window
    from slidingwindowdecoder_torch.harness.circuit_level import global_decoder
    from slidingwindowdecoder_torch.utils.metrics import rates_compatible

    res = {}
    for name, (kw, shots, rates, held, exact, kernels) in GLOBAL_FORMS.items():
        reset_counts()
        t0 = time.perf_counter()
        calls = bp_calls.setdefault(name, {}) if name != "osd0" else {}
        with (first_calls(bposd, "osd_decode", osd_shape, captured),
              first_calls(bposd, "bp_run", fused_bp_call, calls),
              first_calls(osd_window, "bp_run", fused_bp_call, calls)):
            r = global_decoder(144, 0.004, 12, shots, seed=SEED, verbose=False, device="cuda",
                               **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = read_counts()
        nf, nfl = r["num_failed"], r["num_flagged"]
        within = {k: rates_compatible(nf, shots, *v) for k, v in rates.items()}
        verdict = "; ".join(f"{k} {v[0]}/{v[1]}, within 3 sigma: {within[k]}"
                            for k, v in rates.items()) or f"no reference; flagged {nfl}"
        log(f"[global] {name}: failed {nf} flagged {nfl} of {shots} (LER/round "
            f"{r['ler_per_round']:.4e}; {verdict}); {r['shots_per_sec']:.1f} shots/s "
            f"({r['decode_seconds']:.3f}s timed, {wall:.1f}s with set-up and the warm-up "
            f"chunk); launches {launches} (the warm-up's included); plain calls {plain}")
        first = next(iter(rates), None)
        if nf != exact or (held and not within[first]) or (not rates and nfl):
            raise SystemExit(f"[global] {name}: {nf} failures ({nfl} flagged), want {exact}"
                             + (f" within 3 sigma of {rates[first]}" if held else "")
                             + ("" if rates else ", none flagged"))
        check_kernels(f"[global] {name}", launches, plain, kernels)
        res[name] = {"num_failed": nf, "num_flagged": nfl, "shots": shots,
                     "within_3_sigma": within, "seconds": r["decode_seconds"],
                     "shots_per_s": r["shots_per_sec"], "wall_with_warmup_s": wall,
                     "launches": launches}
    return res


def fused_bp_call(garr, mv, prior, synd, *_, num_iter, msg_dtype="float32", **__):
    """``first_calls`` key of a batch-major ``bp_run`` call that the fused
    BP kernel takes on either route: (m, n, B, num_iter); None for one it
    does not take."""
    from slidingwindowdecoder_torch.ops.bp import msg_torch_dtype
    from slidingwindowdecoder_torch.ops.bp_cuda import span_route

    B = synd.shape[0]
    if prior.ndim == 1 and span_route(garr, B, msg_torch_dtype(msg_dtype)) is not None:
        return garr["m"], garr["n"], B, num_iter
    return None


def phase_sw_wide(captured: dict):
    """``[sw_wide]``: the wide sliding windows (``SW_WIDE``), each through
    ``phase_path`` with ``sliding_window_decoder``'s decoder (BP+OSD-CS-10,
    default knobs, f32) on ``SW_WIDE_SHOTS`` shots from seed 2024. During
    each run the first ``bp_run`` call that the fused BP kernel takes is
    recorded for each window shape, batch and span (the whole-batch phase
    A and the two phase-B spans), and the first ``osd_decode`` call for
    each window shape; after it, each goes through ``_span_case`` (against
    the plain loop on the CPU over its first ``SW_WIDE_CPU_SHOTS`` shots)
    or ``_osd_cs_case`` (against the plain elimination and sweep on the
    card), bit-exact. The first OSD bucket of a [[288]] W=4 interior window
    (576x4896) goes into ``captured`` for ``[gj_cluster]``. Returns the
    paths' results and the kernel checks, by kernel and case."""
    import torch

    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.decoders import bposd
    from slidingwindowdecoder_torch.harness.circuit_level import (
        build_bb_window_experiment,
        window_decoder_factory,
    )
    from slidingwindowdecoder_torch.ops import bp_cuda, gf2_cuda
    from slidingwindowdecoder_torch.ops.bp import span_inputs

    res, checks = {}, {"bp_span": {}, "bp_span_wide": {}, "osd_cs_fused": {},
                       "osd_cs_fused_cluster": {}}
    for name, (N, p, rounds, W, ref, exact, kernels) in SW_WIDE.items():
        _, _, dem, plan = build_bb_window_experiment(N, p, rounds, W, 1)
        det, obs, _ = sample_dem_numpy(dem, SW_WIDE_SHOTS, np.random.default_rng(SEED))
        bp_calls, osd_calls = {}, {}
        with (first_calls(bposd, "bp_run", fused_bp_call, bp_calls),
              first_calls(bposd, "osd_decode", osd_shape, osd_calls)):
            r = phase_path(f"sw_wide {name}", plan, det, obs,
                           window_decoder_factory(False, device="cuda"), rounds, ref, exact,
                           kernels)
        r.pop("e_hat")
        r.pop("window_counts")
        res[name] = {"windows": [list(w.mat.shape) for w in plan.windows], **r}
        for (m, n, B, it), (a, k) in bp_calls.items():
            args, kw = span_inputs(*a, **k)
            label = f"{name} {m}x{n} {k.get('msg_dtype', 'float32')} B={B}, {it} iterations"
            cpu_garr = {x: v.cpu() if torch.is_tensor(v) else v for x, v in a[0].items()}
            r = _span_case(label, args, kw, cpu_garr, 5, cpu_shots=SW_WIDE_CPU_SHOTS,
                           ring_times=False)
            checks["bp_span_wide" if r["table_route"] == bp_cuda.WIDE else "bp_span"][label] = r
            if (m, n, it) == (576, 4752, 48):  # an edge window's span on the wide route too
                label += ", wide route forced"
                checks["bp_span_wide"][label] = _span_case(
                    label, args, kw, cpu_garr, 5, cpu_shots=SW_WIDE_CPU_SHOTS,
                    ring_times=False, route=bp_cuda.WIDE)
        for (m, n), (a, k) in osd_calls.items():
            if (m, n) == (576, 4896):
                captured[m, n] = (a, k)
                continue
            C = gf2_cuda.gj_route(m, n, a[0].shape[1], True)
            label = f"{name} {m}x{n}, first OSD bucket"
            checks["osd_cs_fused_cluster" if C else "osd_cs_fused"][label] = _osd_cs_case(
                label, *a[:4], **k, reps=10, plain_reps=1)
        del bp_calls, osd_calls
        torch.cuda.empty_cache()
    return res, checks


def phase_bp_span_wide(bp_calls: dict):
    """``[bp_span_wide]``: the fused kernel's wide route on the first
    ``bp_run`` call of each batch and span that the global decode's
    BP+OSD-CS form (bf16: phase A on the 8192-shot chunk, the two phase-B
    spans on 1024-shot buckets) and shortened form (f32, pinned: the pre-BP
    chunk and the first post-BP bucket) gave it in ``[global]``, through
    ``_span_case``: against the plain loop on the CPU over the first
    ``SW_WIDE_CPU_SHOTS`` shots, bit-exact, with its time beside the per-op
    loop's on the card (kernel A's) and the bound. Returns the cases by
    label, each ``_span_case``'s result."""
    import torch

    from slidingwindowdecoder_torch.ops import bp_cuda
    from slidingwindowdecoder_torch.ops.bp import span_inputs

    res = {}
    for form, calls in bp_calls.items():
        for (m, n, B, it), (a, k) in calls.items():
            args, kw = span_inputs(*a, **k)
            label = (f"global {form} {m}x{n} {k.get('msg_dtype', 'float32')}"
                     f"{' pinned' if kw['masked'] else ''} B={B}, {it} iterations")
            cpu_garr = {x: v.cpu() if torch.is_tensor(v) else v for x, v in a[0].items()}
            r = _span_case(label, args, kw, cpu_garr, 5, cpu_shots=SW_WIDE_CPU_SHOTS,
                           ring_times=False)
            if r["table_route"] != bp_cuda.WIDE:
                raise SystemExit(f"[bp_span_wide] {label} took the {r['table_route']} route")
            res[label] = r
        calls.clear()
    torch.cuda.empty_cache()
    return res


def _cpu_reference(args, kw, k: int):
    """The plain elimination and OSD-CS sweep on the machine's CPU over the
    first ``k`` shots of an ``osd_decode`` call's arguments."""
    import torch

    from slidingwindowdecoder_torch.ops.gf2_solve import (
        _osd_sweep_cs_sortless,
        ordered_gauss_jordan_key,
    )

    Hw, s, key, llr = (x.cpu() for x in args[:4])
    s, key = s[:k], key[:k]
    meta = kw["meta"]
    pi, pj = (torch.as_tensor(meta[x]).cpu() for x in ("pair_i", "pair_j"))
    t0 = time.perf_counter()
    gj = ordered_gauss_jordan_key(Hw, s, key, m=kw["m"], n=kw["n"], rank=kw["rank"])
    sol, min_pm = _osd_sweep_cs_sortless(gj, key, llr, pi, pj, order_w=int(meta["order_w"]))
    return {"shots": s.shape[0], "gj": gj, "solution": sol, "min_pm": min_pm,
            "seconds": time.perf_counter() - t0}


def _round_split(label, args, kw, C: int, fused_ms: float, elim_ms: float, probe):
    """Where one shot's time goes on the cluster route: both entry points
    once more on this bucket in the probe build ``probe``
    (``tools/torch_probe_gj_cluster.py``: clock64 timers, thread 0 of every
    block; its fused outputs must equal the shipped build's), giving the
    rounds, dead rounds and steps a shot, the cycles a round of each of its
    phases (test and post, the wait for every block's posts, the decision,
    the pivot row's pull, the XOR and the round's end), and the sort and
    load, elimination and sweep shares of the fused launch; with the waves
    of clusters the bucket runs in (the probe's ``max_active``), the
    elimination's time a round."""
    import torch

    from slidingwindowdecoder_torch.ops import gf2_cuda

    import torch_probe_gj_cluster as probe_tool  # on the path since phase_build

    Hw, synd, key, llr = args[:4]
    m, n, rank, meta = kw["m"], kw["n"], kw["rank"], kw["meta"]
    B, W = synd.shape[0], Hw.shape[1]
    pi, pj = (torch.as_tensor(meta[x], dtype=torch.int32, device="cuda")
              for x in ("pair_i", "pair_j"))

    def fused():
        return gf2_cuda.osd_cs_fused(Hw, synd, key, llr, pi, pj, m=m, n=n, rank=rank,
                                     order_w=int(meta["order_w"]))

    ref = fused()
    got, fs = probe_tool.probe_split(probe, fused, B * C)
    _, es = probe_tool.probe_split(
        probe, lambda: gf2_cuda.gauss_jordan_key(Hw, synd, key, m=m, n=n, rank=rank), B * C)
    gf2_cuda.osd_cs_fused.cluster_launches = gf2_cuda.gauss_jordan_key.cluster_launches = 0
    if not (torch.equal(got["solution"], ref["solution"])
            and torch.equal(got["min_pm"].view(torch.int32), ref["min_pm"].view(torch.int32))):
        raise SystemExit(f"[gj_cluster] {label}: the probe build disagrees with the kernel")
    cnt, share = fs["counts_per_block"], fs["share_of_block_cycles"]
    active = probe_tool.max_active(probe, m, n, W, C, True)
    waves = -(-B // active)
    split = {"steps_per_shot": cnt["steps"], "rounds_per_shot": cnt["rounds"],
             "dead_rounds_per_shot": cnt["dead_rounds"],
             "candidates_per_round": gf2_cuda.ROUND_CANDIDATES, "clusters_at_once": active,
             "waves": waves, "us_per_round": elim_ms * 1e3 / (waves * cnt["rounds"]),
             "cycles_per_round": es["cycles_per_round"],
             "fused_shares": {k: share[k] for k in ("load", "elimination", "sweep", "finish")}}
    log(f"[gj_cluster] {label} split (probe build): {cnt['steps']:.1f} steps and "
        f"{cnt['rounds']:.1f} rounds a shot ({cnt['dead_rounds']:.1f} dead, "
        f"{gf2_cuda.ROUND_CANDIDATES} candidates a round); {active} clusters at once, {waves} "
        f"waves; elimination alone {elim_ms:.4f} ms, {split['us_per_round']:.3f} us a round; "
        f"cycles a round {({k: round(v) for k, v in es['cycles_per_round'].items()})}; fused "
        f"{fused_ms:.4f} ms: sort and load {100 * share['load']:.1f} %, elimination "
        f"{100 * share['elimination']:.1f} %, sweep {100 * share['sweep']:.1f} %")
    return split


def phase_gj_cluster(plan, cap288, cap_global, probe):
    """``[gj_cluster]``: kernel B's cluster route, both entry points, on the
    card against the plain elimination and sweep on the card over the whole
    bucket and on the machine's CPU over its first ``GJ_CLUSTER_CPU_SHOTS``
    shots (``_gj_case``, ``_osd_cs_case``), bit-exact: tie keys at 216x1728
    with the route forced to 4 blocks (random syndromes, 256 shots); the
    first OSD bucket of a [[288]] W=4 interior window (576x4896, C=2) and of
    the global decode (936x8784, C=8), both captured from the paths' runs
    (real syndromes and BP reliabilities), each with its split
    (``_round_split``) and, in the log only, the time before the redesign
    (``GJ_CLUSTER_BEFORE_MS``), and the [[288]] bucket's fused launch also
    timed at C=4 and C=8. The kernels line keeps the global case."""
    import torch

    from slidingwindowdecoder_torch.ops import gf2_cuda
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        analyze_patterns,
        gf2_rank_packed,
        osd_candidate_patterns,
        pack_rows_host,
    )

    import torch_probe_gj_cluster as probe_tool  # on the path since phase_build

    gen = torch.Generator(device="cuda").manual_seed(14)
    spec, B = plan.windows[1], 256
    m, n = spec.mat.shape
    rank = gf2_rank_packed(spec.mat)
    pr = np.asarray(spec.prior, np.float64)
    ties = ((torch.as_tensor(pack_rows_host(spec.mat).view(np.int32), device="cuda"),
             (torch.rand((B, m), generator=gen, device="cuda") < 0.1).to(torch.uint8),
             _tie_keys(gen, B, n),
             torch.as_tensor(np.log((1 - pr) / pr).astype(np.float32), device="cuda")),
            dict(m=m, n=n, rank=rank, meta=analyze_patterns(
                osd_candidate_patterns(n - rank, 10, "osd_cs"), n - rank)))
    cases = [(f"{m}x{n} tie keys, forced", ties, 4, 20),
             ("[[288]] W=4 window, first OSD bucket (576x4896)", cap288, None, 10),
             ("[[144]] global DEM, first OSD bucket (936x8784)", cap_global, None, 5)]
    res = {"gauss_jordan_key_cluster": {"max_abs_err": 0.0},
           "osd_cs_fused_cluster": {"max_abs_err": 0.0}}
    for label, (args, kw), C, reps in cases:
        cpu_ref = _cpu_reference(args, kw, GJ_CLUSTER_CPU_SHOTS)
        W = args[0].shape[1]
        log(f"[gj_cluster] {label}: {args[1].shape[0]} shots, C="
            f"{C or gf2_cuda.gj_cluster_supported(kw['m'], kw['n'], W, True)}; CPU plain over "
            f"{cpu_ref['shots']} shots {cpu_ref['seconds']:.1f}s")
        got = {}
        for name, case, nargs in (("gauss_jordan_key_cluster", _gj_case, 3),
                                  ("osd_cs_fused_cluster", _osd_cs_case, 4)):
            r = case(label, *args[:nargs], **kw, cluster_blocks=C, cpu_ref=cpu_ref, reps=reps,
                     plain_reps=1)
            got[name] = r
            out = res[name]
            out["max_abs_err"] = max(out["max_abs_err"], r["max_abs_err"])
            if "global" in label:
                out.update(r, max_abs_err=out["max_abs_err"])
            elif "288" in label:
                out["sw_288_w4"] = r
        if C is None:  # a path's bucket: the times before, and the split
            shape = f"{kw['m']}x{kw['n']}"
            fused, alone = got["osd_cs_fused_cluster"], got["gauss_jordan_key_cluster"]
            Cr = gf2_cuda.gj_cluster_supported(kw["m"], kw["n"], W, True)
            split = _round_split(label, args, kw, Cr, fused["ms"], alone["ms"], probe)
            before = GJ_CLUSTER_BEFORE_MS[shape]
            for r in got.values():
                r["split"] = split
            log(f"[gj_cluster] {shape}: fused {fused['ms']:.4f} ms (before {before['fused']}, "
                f"bound {fused['bound_ms']:.5f}: {fused['ms'] / fused['bound_ms']:.1f}x), "
                f"elimination alone {alone['ms']:.4f} ms (before {before['alone']}, bound "
                f"{alone['bound_ms']:.5f}: {alone['ms'] / alone['bound_ms']:.1f}x)")
            if shape == "576x4896":  # C and the block: the same bucket on 4 and 8 blocks
                Hw, s, key, llr = args[:4]
                meta = kw["meta"]
                pi, pj = (torch.as_tensor(meta[x], dtype=torch.int32, device="cuda")
                          for x in ("pair_i", "pair_j"))
                for Cx in (4, 8):
                    ms = cuda_time_ms(lambda: gf2_cuda.osd_cs_fused(
                        Hw, s, key, llr, pi, pj, m=kw["m"], n=kw["n"], rank=kw["rank"],
                        order_w=int(meta["order_w"]), cluster_blocks=Cx), reps)
                    fused[f"ms_C{Cx}"] = ms
                    log(f"[gj_cluster] {shape} fused on clusters of {Cx}: {ms:.4f} ms ("
                        f"{gf2_cuda.cluster_smem_bytes(kw['m'], kw['n'], W, Cx, True)} B a "
                        f"block, {probe_tool.max_active(probe, kw['m'], kw['n'], W, Cx, True)} "
                        f"clusters at once)")
                gf2_cuda.osd_cs_fused.cluster_launches = 0
    return res


def global_core(dev: str):
    """The first ``GLOBAL_SLICE_SHOTS`` seed-2024 global shots decoded by
    ``global_decoder``'s decoder (BP+OSD-CS-10) on ``dev``: its outputs as
    numpy, and seconds."""
    import torch

    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.harness.circuit_level import (
        build_bb_window_experiment,
        build_global_decoder,
    )

    dem = build_bb_window_experiment(144, 0.004, 12, 3, 1)[2]
    det, _, _ = sample_dem_numpy(dem, GLOBAL_SLICE_SHOTS, np.random.default_rng(SEED))
    t0 = time.perf_counter()
    out = build_global_decoder(dem, device=dev).core(torch.as_tensor(det, device=dev))
    return ({k: out[k].cpu().numpy() for k in ("error", "converged", "iterations",
                                               "osd_applied")}, time.perf_counter() - t0)


def phase_global_slice():
    """``[global_slice]``: ``global_core`` on the card now, and on the CPU
    by the plain versions as a deferred CPU half: no shot may differ in
    error, convergence, iterations or OSD use."""
    a, ta = global_core("cuda")

    def compare(refs):
        (b, tb), = refs
        shots = len(a["error"])
        differ = np.zeros(shots, bool)
        for k in a:
            differ |= (a[k] != b[k]).reshape(shots, -1).any(axis=1)
        log(f"[global_slice] card vs CPU plain over {shots} shots: "
            f"{int(a['osd_applied'].sum())} through OSD, shots differing {int(differ.sum())}; "
            f"{ta:.1f}s card, {tb:.1f}s CPU")
        if differ.any():
            raise SystemExit(f"[global_slice] {int(differ.sum())} shots differ")

    return "global_slice", global_core, [("cpu",)], compare



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


def cc_decode(which: str, kw: dict, synd, dev: str):
    """``synd`` decoded by the [[882]] parity decoder ``which`` (at CC_P,
    overrides ``kw``) on ``dev``: the ``DecodeResult``, and seconds."""
    from slidingwindowdecoder_torch.harness.code_capacity import parity_code, parity_decoder

    t0 = time.perf_counter()
    r = parity_decoder(parity_code(882), CC_P, which, kw, device=dev).decode_batch(synd)
    return r, time.perf_counter() - t0


def phase_cc_slice(synd):
    """``[cc_slice]``: the first ``CC_SLICE_SHOTS`` [[882]] syndromes
    decoded by BPGD's loop form and its spans form with 64-row buckets on
    the card now, and by BPGD (max_step 100) and GDG's spans form (the
    cc882-gdg row's knobs) on the card now and by the plain versions on the
    CPU as deferred CPU halves (returned): no shot may differ in error,
    convergence, iterations or min_pm."""
    from slidingwindowdecoder_torch.harness.code_capacity import PARITY_ROWS

    first = synd[:CC_SLICE_SHOTS]
    bpgd_kw = {"max_step": 100}

    def check(label, a, bs):
        (ra, ta), ((rb, tb),) = a, bs
        differ = results_differ(ra, rb, len(first))
        log(f"[cc_slice] {label}, {len(first)} shots: converged {int(ra.converged.sum())}, "
            f"shots differing {int(differ.sum())}; {ta:.1f}s and {tb:.1f}s")
        if differ.any():
            raise SystemExit(f"[cc_slice] {label}: {int(differ.sum())} shots differ")

    check("BPGD loop vs spans (64-row buckets), card",
          cc_decode("bpgd", {**bpgd_kw, "mode": "loop"}, first, "cuda"),
          [cc_decode("bpgd", {**bpgd_kw, "row_bucket": 64}, first, "cuda")])
    pending = []
    for label, which, kw in (
            ("BPGD card vs CPU", "bpgd", bpgd_kw),
            ("GDG spans card vs CPU", "gdg",
             {**PARITY_ROWS["cc882-gdg"][4], "ensemble_mode": "spans"})):
        card = cc_decode(which, kw, first, "cuda")
        pending.append((f"cc_slice {which}", cc_decode, [(which, kw, first, "cpu")],
                        functools.partial(check, label, card)))
    return pending


# ---------------------------------------------------------------------------
# The CPU halves of the card-vs-CPU phases are deferred: each phase runs its
# card half in place and returns (name, worker function, the arguments of
# each of its worker tasks, comparison of the tasks' results). They run
# after the last timed phase, so that no rate or time the script reports is
# read under their load: one single-threaded worker process a core of the
# machine (8), the largest halves first (their CPU seconds on two threads:
# about 250, 210, 162 and 133; the rest under 100 each), the window decodes
# cut into CPU_PIECES tasks each.
CPU_WORKERS, CPU_WORKER_THREADS, CPU_PIECES = 8, 1, 4
# the order the halves' tasks start in, longest first: the halves of one
# task each (the [[882]] GDG slice, the serial queue and the global slice:
# 135, 79 and 68 s of CPU on the card's host), then the four-piece halves
# by size, then the rest
CPU_LARGEST_FIRST = ("cc_slice gdg", "gdg_serial", "global_slice", "osd_window_slice",
                     "gdg_wide_slice", "gdg_slice", "gdg_bf16_slice")


def _cpu_worker_init():
    import torch

    torch.set_num_threads(CPU_WORKER_THREADS)


def run_cpu_halves(pending):
    """Run the tasks of every deferred CPU half of ``pending`` in the worker
    pool and hold each half against its card half as it ends; on any exit,
    cancel what has not started and wait for the rest, so no worker
    outlives the call."""
    import concurrent.futures
    import multiprocessing

    rank = {name: i for i, name in enumerate(CPU_LARGEST_FIRST)}
    pending = sorted(pending, key=lambda t: rank.get(t[0], len(rank)))
    t0 = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(
        CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_cpu_worker_init)
    try:
        futures = [([pool.submit(fn, *args) for args in tasks], compare)
                   for _, fn, tasks, compare in pending]
        for tasks, compare in futures:
            compare([f.result() for f in tasks])
    finally:
        pool.shutdown(cancel_futures=True)
    log(f"[cpu_halves] {len(pending)} CPU halves, {sum(len(t) for t, _ in futures)} tasks, on "
        f"{CPU_WORKERS} workers of {CPU_WORKER_THREADS} thread: "
        f"{time.perf_counter() - t0:.1f}s")


def experiment_plan(exp):
    """The window plan of ``exp`` = (N, p, rounds, W, F)."""
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment

    return build_bb_window_experiment(*exp)[3]


def window_factory(kind: str, kw: dict, dev):
    """The per-window decoder factory of a path: "bposd" (BP+OSD,
    ``sliding_window_decoder``'s), "osd_window" (the shortened decoder) or
    "gdg" (``sliding_window_gdg``'s)."""
    from slidingwindowdecoder_torch.harness.circuit_level import (
        gdg_window_factory,
        window_decoder_factory,
    )

    if kind == "gdg":
        return gdg_window_factory(device=dev, **kw)
    return window_decoder_factory(kind == "osd_window", device=dev, **kw)


def cpu_window_decode(exp, det, obs, kind: str, kw: dict):
    """Worker task: ``window_decode`` by the plain versions on the CPU."""
    return window_decode(experiment_plan(exp), det, obs, window_factory(kind, kw, "cpu"), "cpu")


def gdg_serial_decode(spec, synd, dev):
    """``GDG(multi_thread=False)`` with ``sliding_window_gdg``'s window knobs
    (pre-BP 8, the reference's defaults) on one window's syndromes: the
    decode result as numpy, and seconds."""
    from slidingwindowdecoder_torch.decoders import GDG

    t0 = time.perf_counter()
    r = GDG(spec.mat, spec.prior, max_iter=8, multi_thread=False, device=dev).decode_batch(synd)
    return r, time.perf_counter() - t0


def cpu_gdg_serial(exp, window: int, synd):
    """Worker task: ``gdg_serial_decode`` on the CPU."""
    return gdg_serial_decode(experiment_plan(exp).windows[window], synd, "cpu")


# the GDG path at the JAX package's GDG parity knobs (bf16 messages and
# history ring, the span-compacted ensemble, 512-shot ensemble buckets;
# tools/validate_parity.py:88-112) on the GDG path's samples; the port's
# own count at seed 2024 (its first run on the card, PERF.md); the shots
# its card-vs-CPU slice takes
GDG_BF16_KNOBS = dict(max_iter=8, ensemble_bucket=512, ensemble_mode="spans",
                      msg_dtype="bfloat16", hist_dtype="bfloat16")
GDG_BF16_FAILED = 668
GDG_BF16_SLICE_SHOTS = 32
# gdg-last-osd: [[288,12,18]] W=4, r=6, p=0.005 at the JAX rows' knobs (SW
# GDG.ipynb cell ccb3047b: pre-BP 16, 60 steps, tree 4 / side 20, branch
# steps 40; 47 branches), then BP+OSD-CS-10 on the last window; the
# reference's 136/20000 and, with the last-window OSD, 85/20000; the
# port's own counts at seed 2024 over GDG_WIDE_SHOTS shots (its first run
# on the card, PERF.md); the shots of its card-vs-CPU slice
GDG_WIDE_EXP = (288, 0.005, 6, 4, 1)
GDG_WIDE_KNOBS = dict(GDG_BF16_KNOBS, max_iter=16, max_step=60, max_tree_depth=4,
                      max_side_depth=20, max_tree_branch_step=40, max_side_branch_step=40)
GDG_WIDE_SHOTS, GDG_WIDE_SLICE_SHOTS = 512, 16
REF_GDG_WIDE, REF_GDG_WIDE_OSD = (136, 20000), (85, 20000)
GDG_WIDE_FAILED, GDG_WIDE_OSD_FAILED = 4, 3
# the serial work queue on window 0 of the GDG path's samples
GDG_SERIAL_SHOTS = 256


@contextlib.contextmanager
def burst_capture(store: dict, depth: int = 4):
    """Record in ``store``, under the window graph's n, the arguments of the
    first GDG ensemble burst (the ``bp_run`` of ``_ensemble_step``) at
    ``depth`` on each graph while the block runs (``first_calls``: cloned;
    no kernel runs for it). Depth 4 is the step after the tree-side
    branches restarted their messages."""
    from slidingwindowdecoder_torch.decoders import gdg

    step = gdg._ensemble_step

    def tagged(garr, *a, **k):
        if a[5] != depth or garr["n"] in store:
            return step(garr, *a, **k)
        with first_calls(gdg, "bp_run", lambda *_, **__: garr["n"], store):
            return step(garr, *a, **k)

    gdg._ensemble_step = tagged
    try:
        yield
    finally:
        gdg._ensemble_step = step


def phase_gdg_bf16(exp, plan, det, obs, num_repeat: int, captured: dict):
    """``[gdg_bf16]``: the GDG path at the JAX package's parity knobs
    (``GDG_BF16_KNOBS``) through ``phase_path``: exactly ``GDG_BF16_FAILED``
    failures, within 3 sigma of the reference's 400/5000, launching only
    ``bp_span`` (the pre-BP, with an f32 ring) and ``bp_span_pinned`` with a
    bf16 ring (every pinned launch took one). Each window width's burst at
    depth 4 goes into ``captured``. Then the first ``GDG_BF16_SLICE_SHOTS``
    shots through ``phase_card_vs_cpu``: returns the results and the
    deferred CPU half."""
    factory = window_factory("gdg", GDG_BF16_KNOBS, "cuda")
    with burst_capture(captured):
        res = phase_path("gdg_bf16", plan, det, obs, factory, num_repeat,
                         (REF_GDG_FAILED, REF_GDG_SHOTS), GDG_BF16_FAILED,
                         ("bp_span", "bp_span_pinned", "bp_span_pinned_bf16_ring"))
    la = res["launches"]
    if la["bp_span_pinned_bf16_ring"] != la["bp_span_pinned"]:
        raise SystemExit(f"[gdg_bf16] a burst ran without the bf16 ring: {la}")
    res.pop("e_hat")
    res["ensemble_bucket"] = GDG_BF16_KNOBS["ensemble_bucket"]
    k = GDG_BF16_SLICE_SHOTS
    return res, phase_card_vs_cpu("gdg_bf16_slice", exp, plan, det[:k], obs[:k], "gdg",
                                  GDG_BF16_KNOBS)


def phase_gdg_serial(exp, plan, det):
    """``[gdg_serial]``: ``GDG(multi_thread=False)`` on window 0's PCM over
    its first ``GDG_SERIAL_SHOTS`` syndromes of the GDG path's samples, on
    the card with the launch counts read around it (``bp_span`` for the
    pre-BP, ``bp_span_pinned`` for every step); returns the results and the
    same decode by the plain versions on the CPU as a deferred CPU half, in
    which no shot may differ in error, convergence, iterations or
    min_pm."""
    import torch

    spec = plan.windows[0]
    synd = det[:GDG_SERIAL_SHOTS, spec.row_start:spec.row_end]
    reset_counts()
    rc, tc = gdg_serial_decode(spec, synd, "cuda")
    torch.cuda.synchronize()
    launches, plain = read_counts()
    queued = int((rc.iterations > 8).sum())
    log(f"[gdg_serial] window 0 ({spec.mat.shape[0]}x{spec.mat.shape[1]}), {len(synd)} "
        f"syndromes, {queued} past the pre-BP: converged {int(rc.converged.sum())}; "
        f"{tc:.2f}s card ({len(synd) / tc:.1f} shots/s); launches {launches}; plain calls "
        f"{plain}")
    check_kernels("[gdg_serial]", launches, plain, ("bp_span", "bp_span_pinned"))
    if not queued:
        raise SystemExit("[gdg_serial] no syndrome reached the queue")

    def compare(refs):
        (rp, tp), = refs
        differ = results_differ(rc, rp, len(synd))
        log(f"[gdg_serial] card vs CPU plain over {len(synd)} syndromes: shots differing "
            f"{int(differ.sum())}; {tc:.2f}s card, {tp:.1f}s CPU")
        if differ.any():
            raise SystemExit(f"[gdg_serial] {int(differ.sum())} shots differ")

    return ({"shots": len(synd), "seconds": tc, "shots_per_s": len(synd) / tc,
             "past_pre_bp": queued, "converged": int(rc.converged.sum()),
             "launches": launches},
            ("gdg_serial", cpu_gdg_serial, [(exp, 0, synd)], compare))


def phase_gdg_wide(captured: dict, plan, det, obs):
    """``[gdg_wide]``: gdg-last-osd through ``sliding_window_gdg`` (its
    warm-up decode included in the launch counts) on ``GDG_WIDE_SHOTS``
    seed-2024 shots: the GDG and last-window-OSD failures equal to the
    port's own counts and within 3 sigma of the reference's rates, the
    launches ``bp_span`` (the pre-BP, f32 ring), ``bp_span_pinned`` with a
    bf16 ring and the cluster route of ``osd_cs_fused`` (the last window's
    OSD on 576x4752) only. Each window width's burst at depth 4 goes into
    ``captured``. The first pre-BP call of each window shape (unmasked bf16,
    512 shots, 16 iterations, one shot a block) is recorded during the run
    (``first_calls``) and held after it through ``_span_case``, against the
    plain loop on the CPU over its first ``SW_WIDE_CPU_SHOTS`` shots. Then
    ``det`` (the first ``GDG_WIDE_SLICE_SHOTS`` shots) through
    ``phase_card_vs_cpu``. Returns the results, the ``_span_case`` results
    by case, and the deferred CPU half."""
    import torch

    from slidingwindowdecoder_torch.harness.circuit_level import sliding_window_gdg
    from slidingwindowdecoder_torch.ops import bp as bp_ops
    from slidingwindowdecoder_torch.ops.bp import span_inputs
    from slidingwindowdecoder_torch.utils.metrics import rates_compatible

    N, p, rounds, W, F = GDG_WIDE_EXP
    pre_calls = {}
    reset_counts()
    t0 = time.perf_counter()
    with burst_capture(captured), first_calls(bp_ops, "bp_run", fused_bp_call, pre_calls):
        r = sliding_window_gdg(N, p, rounds, GDG_WIDE_SHOTS, W=W, F=F, last_win_osd=True,
                               seed=SEED, verbose=False, device="cuda", **GDG_WIDE_KNOBS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    nf, nfo = r["num_failed"], r["last_win_osd"]["num_failed"]
    ok = rates_compatible(nf, GDG_WIDE_SHOTS, *REF_GDG_WIDE)
    ok_osd = rates_compatible(nfo, GDG_WIDE_SHOTS, *REF_GDG_WIDE_OSD)
    log(f"[gdg_wide] [[288]] W=4 r=6: GDG failed {nf} flagged {r['num_flagged']} of "
        f"{GDG_WIDE_SHOTS} (reference {REF_GDG_WIDE[0]}/{REF_GDG_WIDE[1]}, within 3 sigma: "
        f"{ok}); with the last-window OSD {nfo} (reference {REF_GDG_WIDE_OSD[0]}/"
        f"{REF_GDG_WIDE_OSD[1]}, within 3 sigma: {ok_osd}); {r['shots_per_sec']:.2f} shots/s "
        f"({r['decode_seconds']:.2f}s timed, {wall:.1f}s with the warm-up decode); launches "
        f"{launches} (the warm-up's included); plain calls {plain}")
    if (nf, nfo) != (GDG_WIDE_FAILED, GDG_WIDE_OSD_FAILED) or not (ok and ok_osd):
        raise SystemExit(f"[gdg_wide] {nf} / {nfo} failures, want {GDG_WIDE_FAILED} / "
                         f"{GDG_WIDE_OSD_FAILED} within 3 sigma")
    check_kernels("[gdg_wide]", launches, plain, ("bp_span", "bp_span_pinned",
                                                  "bp_span_pinned_bf16_ring",
                                                  "osd_cs_fused_cluster"))
    if launches["bp_span_pinned_bf16_ring"] != launches["bp_span_pinned"]:
        raise SystemExit(f"[gdg_wide] a burst ran without the bf16 ring: {launches}")
    shapes = {tuple(w.mat.shape) for w in plan.windows}
    if {(m, n) for m, n, _, _ in pre_calls} != shapes:
        raise SystemExit(f"[gdg_wide] pre-BP calls recorded at {sorted(pre_calls)}, want one "
                         f"at each window shape {sorted(shapes)}")
    checks = {}
    for (m, n, B, it), (a, k) in sorted(pre_calls.items()):
        args, kw = span_inputs(*a, **k)
        label = f"gdg_wide pre-BP {m}x{n} {k.get('msg_dtype', 'float32')} B={B}, {it} iterations"
        cpu_garr = {x: v.cpu() if torch.is_tensor(v) else v for x, v in a[0].items()}
        checks[label] = _span_case(label, args, kw, cpu_garr, 5, cpu_shots=SW_WIDE_CPU_SHOTS,
                                   ring_times=False)
    res = {"shots": GDG_WIDE_SHOTS, "num_failed": nf, "num_flagged": r["num_flagged"],
           "last_win_osd_failed": nfo, "within_3_sigma": ok, "osd_within_3_sigma": ok_osd,
           "seconds": r["decode_seconds"], "shots_per_s": r["shots_per_sec"],
           "wall_with_warmup_s": wall, "launches": launches,
           "windows": [list(w.mat.shape) for w in plan.windows]}
    return res, checks, phase_card_vs_cpu("gdg_wide_slice", GDG_WIDE_EXP, plan, det, obs, "gdg",
                                          GDG_WIDE_KNOBS)


# columns of a captured GDG burst that the plain loop also takes on the
# machine's CPU (every column of the bursts seen so far)
BURST_CPU_COLUMNS = 2048


def phase_bp_span_bf16_ring(plans, gdet, captured: dict):
    """``[bp_span_bf16_ring]``: the fused kernel with a bf16 history ring on
    the card against the plain loop on the CPU (``_span_case``), ring,
    error, done, iterations and ``synd_hat`` bit-exact, each timed beside
    the same input with an f32 ring: the GDG bursts at depth 4 captured at
    every window width of ``plans`` (``[gdg_bf16]``'s [[144]] W=3 windows:
    bf16 messages, transposed state, tail history, 6 iterations, a row
    bucket of the spans form; ``[gdg_wide]``'s [[288]] W=4 windows,
    576x4896 and 576x4752, one shot a block; the CPU over the first
    ``BURST_CPU_COLUMNS`` columns), and one unmasked case: the window-0
    pre-BP of ``[gdg_bf16]`` (``gdet``: 8192 shots, 8 bf16 iterations) with
    a bf16 ring written at every iteration (the CPU over its first
    ``SLICE_SHOTS`` shots)."""
    import torch

    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops.bp import bp_init_messages_sm, span_inputs

    res = {}
    drop = ("return_synd", "hist_update", "state_layout", "hist_dtype")
    widths = sorted({w.mat.shape[1] for plan in plans for w in plan.windows})
    if set(captured) != set(widths):
        raise SystemExit(f"[bp_span_bf16_ring] bursts captured at widths {sorted(captured)}, "
                         f"want {widths}")
    for n in widths:
        a, k = captured[n]
        args, kw = span_inputs(*a, **{x: v for x, v in k.items() if x not in drop},
                               transposed=True)
        kw["return_synd"] = True
        B = args[1].shape[2]
        label = f"{a[0]['m']}x{n}"
        cpu_garr = {x: v.cpu() if torch.is_tensor(v) else v for x, v in a[0].items()}
        log(f"[bp_span] {label} GDG burst: {B} columns, {int((~args[8]).sum())} active, "
            f"{float((args[5] != -1).float().mean()):.3f} of the VNs decided")
        res[f"GDG burst {label}"] = _span_case(
            f"GDG burst {label} masked bf16 B={B}", args, kw, cpu_garr, 10,
            cpu_shots=min(B, BURST_CPU_COLUMNS), ring_times=False)
    spec = plans[0].windows[0]
    dec = window_factory("gdg", GDG_BF16_KNOBS, "cuda")(spec)
    garr, llr = dec.garr, torch.as_tensor(dec.llr, device="cuda")
    synd = torch.as_tensor(gdet[:, spec.row_start:spec.row_end], device="cuda")
    B, n = synd.shape[0], spec.mat.shape[1]
    args, kw = span_inputs(
        garr, bp_init_messages_sm(garr, llr, B, "bfloat16"), llr, synd,
        torch.zeros((n, 4, B), dtype=torch.bfloat16, device="cuda"),
        torch.zeros((B, n), dtype=torch.int8, device="cuda"),
        torch.zeros((B,), dtype=torch.bool, device="cuda"),
        torch.zeros((B,), dtype=torch.int32, device="cuda"), num_iter=8,
        msg_dtype="bfloat16", io_layout="slot_major")
    res["pre-BP unmasked"] = _span_case(
        f"pre-BP unmasked bf16 B={B}, 8 iterations, bf16 ring", args, kw,
        graph_tensors(compile_graph(spec.mat), "cpu"), 10, cpu_shots=SLICE_SHOTS,
        ring_times=False)
    return res


# ---------------------------------------------------------------------------
# BP4, CAMEL and the phenomenological and SHYPS drivers: short forms of six
# of the parity rows of tools/torch_validate_depolarizing.py at seed 2024,
# through the rows' entry points (its ``run_row``; the tool runs the full
# rows): the row, its shots here, the
# port's own count at seed 2024 (its first run on the card, PERF.md), and
# the kernels it may launch (BP4's CN stage is kernel A; its OSD, the
# windows' and the whole DEM's, kernel B; the other BP on the fused kernel)
ROW_FORMS = {
    "bp4-osdcs": (8192, 2, ("cn_update", "osd_cs_fused")),
    "camel-362": (4096, 0, ("cn_update",)),
    "phenom-osd": (16384, 348, ("bp_span", "osd_cs_fused")),
    "phenom-gdg": (4096, 5, ("bp_span", "bp_span_pinned")),
    "shyps-window": (4096, 28, ("bp_span", "osd_cs_fused")),
    "shyps-global": (4096, 29, ("bp_span", "osd_cs_fused")),
}
# the rows whose first shots are decoded on the card and on the CPU
ROW_SLICES, ROW_SLICE_SHOTS = ("bp4-osdcs", "camel-362", "phenom-osd", "phenom-gdg",
                               "shyps-window", "shyps-global"), 64
# OSD-E in ``[osd_e]``: its order and the bucket (216x1728)
OSD_E_ORDER, OSD_E_SHOTS = 7, 256


def phase_bp4_cn():
    """``[bp4_cn]``: kernel A at BP4's shapes (one launch a basis an
    iteration): the [[882]] QC-GHP graph (441x882, dc 6, m_pad 448) at a
    2048-shot batch of the bp4 rows, and the [[362]] cycle-assembled graph
    (171x362, dc 20, m_pad 192) at CAMEL's 4 x 1024 branch lanes, f32, on
    random messages with ties, equal values, zeros and values beyond the
    clip (0 at invalid slots, as BP4's messages are), against its plain
    version on the card: bit-exact on every valid edge, with the time and
    the bytes bound."""
    import torch

    from slidingwindowdecoder_torch.codes import (
        create_cycle_assemble_codes,
        create_cyclic_permuting_matrix,
        create_QC_GHP_codes,
    )
    from slidingwindowdecoder_torch.graphs.tanner import compile_graph, graph_tensors
    from slidingwindowdecoder_torch.ops.bp import _cn_update_sm
    from slidingwindowdecoder_torch.ops.bp_cuda import cn_update

    c882 = create_QC_GHP_codes(63, create_cyclic_permuting_matrix(7, [27, 54, 0]), [0, 1, 6])
    gen = torch.Generator(device="cuda").manual_seed(17)
    result = {"max_abs_err": 0.0}
    for name, H, B, alpha in (("bp4_882", c882.hx, 2048, 0.625),
                              ("camel_362", create_cycle_assemble_codes(19, 3).hx, 4096, 0.8)):
        g = compile_graph(H)
        valid = graph_tensors(g, "cuda")["cn_valid_sm"]
        dc, m_pad = g.dc, g.m_pad
        mv = torch.randn((dc, m_pad, B), generator=gen, device="cuda") * 30
        mv[1, ::3] = -mv[0, ::3]  # ties of |x| between slots 0 and 1
        mv[2, ::5] = mv[3, ::5]  # equal values
        mv[4, ::7] = 0.0  # zeros count as negative
        mv[5, ::11] = 80.0  # beyond the clip
        mv = torch.where(valid[:, :, None], mv, 0.0)
        parity = torch.randint(0, 2, (m_pad, B), generator=gen, device="cuda",
                               dtype=torch.int32)

        def kern():
            return cn_update(mv, valid, parity, alpha=alpha, clip=50.0)

        before = cn_update.launches
        out = kern()
        torch.cuda.synchronize()
        if cn_update.launches != before + 1:
            raise SystemExit("[bp4_cn] kernel A was not launched")
        ref = _cn_update_sm(mv, valid, parity, alpha=alpha, clip=50.0)
        edges = valid[:, :, None].expand_as(out)
        same = torch.equal(out[edges].view(torch.int32), ref[edges].view(torch.int32))
        err = float((out[edges] - ref[edges]).abs().max())
        ms = cuda_time_ms(kern, 50)
        plain_ms = cuda_time_ms(
            lambda: _cn_update_sm(mv, valid, parity, alpha=alpha, clip=50.0), 5)
        nbytes = cn_bound_bytes(valid, H.shape[0], B, 4)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shape = f"[{dc},{m_pad},{B}] float32"
        log(f"[bp4_cn] {name} {H.shape[0]}x{H.shape[1]} {shape}, alpha {alpha}: bit-exact on "
            f"the {int(edges.sum())} valid edges={same} max_abs_err={err}; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes {nbytes})")
        if not same:
            raise SystemExit(f"[bp4_cn] kernel A disagrees with its plain version at {shape}")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        result[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "shape": shape}
    cn_update.launches = 0
    return result


def phase_osd_e(plan, det):
    """``[osd_e]``: OSD-E of order ``OSD_E_ORDER`` on a 216x1728 window
    bucket (window 1's rows of the first ``OSD_E_SHOTS`` seed-2024 shots,
    tie keys, the window's priors): kernel B's ``gauss_jordan_key`` against
    the plain elimination on the card and on the CPU (``_gj_case``), then
    ``osd_decode``'s OSD-E branch on the card (the kernel and the dense
    sweep) against the plain elimination and sweep on the CPU: solution,
    OSD-0, inconsistency and the bits of min_pm equal; its time beside the
    elimination's."""
    import torch

    from slidingwindowdecoder_torch.ops.gf2_cuda import gauss_jordan_key
    from slidingwindowdecoder_torch.ops.gf2_solve import (
        analyze_patterns,
        gf2_rank_packed,
        ordered_gauss_jordan_key,
        osd_candidate_patterns,
        osd_decode,
        pack_rows_host,
    )

    spec = plan.windows[1]
    H = spec.mat
    m, n = H.shape
    rank = gf2_rank_packed(H)
    k = n - rank
    Hw = torch.as_tensor(pack_rows_host(H).view(np.int32), device="cuda")
    synd = torch.as_tensor(det[:OSD_E_SHOTS, spec.row_start:spec.row_end], device="cuda")
    key = _tie_keys(torch.Generator(device="cuda").manual_seed(19), OSD_E_SHOTS, n)
    llr = torch.as_tensor(np.log((1 - spec.prior) / spec.prior).astype(np.float32),
                          device="cuda")
    pats = osd_candidate_patterns(k, OSD_E_ORDER, "osd_e")
    meta = analyze_patterns(pats, k)
    meta_card = dict(meta, patterns=torch.as_tensor(pats, device="cuda"))
    cpu = [x.cpu() for x in (Hw, synd, key, llr)]
    gj_cpu = ordered_gauss_jordan_key(*cpu[:3], m=m, n=n, rank=rank)
    res = _gj_case(f"{m}x{n} (OSD-E bucket)", Hw, synd, key, m=m, n=n, rank=rank,
                   cpu_ref={"shots": OSD_E_SHOTS, "gj": gj_cpu})

    def card():
        return osd_decode(Hw, synd, key, llr, m=m, n=n, rank=rank, k=k, meta=meta_card)

    before = gauss_jordan_key.launches
    out = card()
    torch.cuda.synchronize()
    if gauss_jordan_key.launches != before + 1:
        raise SystemExit("[osd_e] kernel B was not launched")
    ref = osd_decode(*cpu, m=m, n=n, rank=rank, k=k, meta=meta)
    pairs = {key_: (out[key_].cpu(), ref[key_]) for key_ in ("solution", "osd0", "inconsistent")}
    pairs["min_pm"] = (out["min_pm"].cpu().view(torch.int32), ref["min_pm"].view(torch.int32))
    bad = [key_ for key_, (x, y) in pairs.items() if not torch.equal(x, y)]
    osd_e_ms = cuda_time_ms(card, 5)
    n_cand = int((ref["solution"] != ref["osd0"]).any(dim=1).sum())
    log(f"[osd_e] order {OSD_E_ORDER} ({len(pats)} candidates) on {m}x{n} B={OSD_E_SHOTS}, "
        f"card vs CPU: equal={not bad}; {n_cand} shots take a candidate, "
        f"{int(ref['inconsistent'].sum())} inconsistent; elimination kernel {res['ms']:.4f} ms, "
        f"with the dense sweep (torch ops) {osd_e_ms:.4f} ms")
    if bad:
        raise SystemExit(f"[osd_e] the card's OSD-E disagrees with the CPU's on {bad}")
    # the entry points that take osd_method="osd_e", on 64 shots of a [[72]]
    # window (x3, W=2, p=0.01), on the card and on the CPU
    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.decoders import BPOSD, OSDWindow
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment

    _, _, dem72, plan72 = build_bb_window_experiment(72, 0.01, 3, 2, 1)
    spec72 = plan72.windows[0]
    det72 = sample_dem_numpy(dem72, 64, np.random.default_rng(SEED))[0]
    synd72 = det72[:, spec72.row_start:spec72.row_end]
    for cls, kw in ((BPOSD, dict(max_iter=8)), (OSDWindow, dict(post_max_iter=8))):
        decode = [cls(spec72.mat, spec72.prior, osd_method="osd_e", osd_order=4, device=d,
                      **kw).decode_batch(synd72) for d in ("cuda", "cpu")]
        diff = int((decode[0].error != decode[1].error).any(axis=1).sum())
        log(f"[osd_e] {cls.__name__}(osd_method='osd_e', osd_order=4) on {len(synd72)} "
            f"{spec72.mat.shape[0]}x{spec72.mat.shape[1]} window syndromes, card vs CPU: "
            f"OSD ran on {int(decode[1].osd_applied.sum())}, shots differing {diff}")
        if diff or not decode[1].osd_applied.any():
            raise SystemExit(f"[osd_e] {cls.__name__}: the card disagrees with the CPU")
    gauss_jordan_key.launches = 0
    return {**res, "osd_e_ms": osd_e_ms, "order": OSD_E_ORDER, "candidates": len(pats)}


def rows_tool():
    """``tools/torch_validate_depolarizing.py``: the parity rows' knobs and
    ``run_row``."""
    from slidingwindowdecoder_torch.utils import cuda_build

    tools = str(cuda_build.CSRC.parents[1] / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import torch_validate_depolarizing

    return torch_validate_depolarizing


def row_slice(name: str, dev: str):
    """The first ``ROW_SLICE_SHOTS`` shots of a row's decoder at seed 2024
    on ``dev`` (the card's half, or a worker task on the CPU): its per-shot
    corrections (numpy) and seconds. The bp4 and CAMEL shots are the first
    ones of the row's samples; the phenomenological shots are the driver's
    draw at that batch size; the SHYPS shots are ``decode_shyps``'s."""
    from slidingwindowdecoder_torch.harness.depolarizing import sample_depolarizing
    from slidingwindowdecoder_torch.harness.shyps import decode_shyps

    pr = rows_tool()
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    kind = pr.ROWS[name][0]
    if kind in pr.BP4_ROWS:
        code, (p, _, camel, _) = pr.row_code(kind), pr.BP4_ROWS[kind]
        dec = pr.bp4_row_decoder(kind, dev)
        ex, ez = sample_depolarizing(code.N, p, ROW_SLICE_SHOTS, rng)
        sx = (ez.astype(np.int64) @ code.hx.T) % 2
        sz = (ex.astype(np.int64) @ code.hz.T) % 2
        e_hat = (dec.camel_decode if camel else dec.decode_batch)(sx, sz).error
    elif kind.startswith("phenom"):
        code, (p, p_synd) = pr.row_code(kind), pr.PHENOM_P
        m = code.hx.shape[0]
        err = (rng.random((ROW_SLICE_SHOTS, code.N)) < p).astype(np.uint8)
        synd_err = (rng.random((ROW_SLICE_SHOTS, m)) < p_synd).astype(np.uint8)
        pcm = np.hstack([code.hx, np.eye(m, dtype=np.uint8)])
        priors = np.concatenate([np.full(code.N, p), np.full(m, p_synd)])
        e_hat = pr.phenom_row_decoder(kind, pcm, priors, dev).decode_batch(
            ((err.astype(np.int64) @ code.hx.T) % 2) ^ synd_err).error
    else:
        e_hat = decode_shyps(num_shots=ROW_SLICE_SHOTS, window=kind == "shyps_window",
                             seed=SEED, verbose=False, device=dev, **pr.SHYPS_KNOBS)["e_hat"]
    return np.asarray(e_hat), time.perf_counter() - t0


def phase_rows(tag: str, names):
    """``[bp4]``, ``[phenom]``, ``[shyps]``: each row of ``names`` through
    ``run_row`` on the card at its ``ROW_FORMS`` shots from seed 2024, with
    the launch counts set to 0 just before and read just after: its
    failures equal to the port's own count and within 3 sigma of the
    reference's rate, every kernel it names launched and no other one, no
    plain call; then, for the rows of ``ROW_SLICES``, the first shots on the
    card now and on the CPU as deferred CPU halves (returned): no shot may
    differ."""
    import torch

    from slidingwindowdecoder_torch.utils.metrics import rates_compatible

    tool = rows_tool()
    res, pending = {}, []
    for name in names:
        shots, exact, kernels = ROW_FORMS[name]
        kind, _, ref, jax_count = tool.ROWS[name]
        reset_counts()
        with contextlib.redirect_stdout(sys.stderr):
            r = tool.run_row(kind, shots, SEED, "cuda")
        torch.cuda.synchronize()
        launches, plain = read_counts()
        nf = r["failures"]
        ok = rates_compatible(nf, shots, *ref)
        log(f"[{tag}] {name}: failed {nf} flagged {r['flagged']} of {shots} (reference "
            f"{ref[0]}/{ref[1]}, within 3 sigma: {ok}; the JAX package {jax_count[0]}/"
            f"{jax_count[1]} at seed 7); {r['shots_per_s']:.1f} shots/s ({r['seconds']:.2f}s); "
            f"launches {({k: v for k, v in launches.items() if v})} (the warm-up's included); "
            f"plain calls {plain}")
        if not ok or nf != exact:
            raise SystemExit(f"[{tag}] {name}: {nf} failures, want {exact} within 3 sigma "
                             f"of {ref[0]}/{ref[1]}")
        check_kernels(f"[{tag}] {name}", launches, plain, kernels)
        res[name] = {"num_failed": nf, "num_flagged": r["flagged"], "shots": shots,
                     "seconds": r["seconds"], "shots_per_s": r["shots_per_s"],
                     "launches": launches}
        if name in ROW_SLICES:
            card = row_slice(name, "cuda")

            def compare(refs, name=name, card=card):
                (e_cpu, t_cpu), = refs
                diff = int((card[0] != e_cpu).reshape(len(e_cpu), -1).any(axis=1).sum())
                log(f"[{tag}] {name}: card vs CPU plain over {len(e_cpu)} shots: shots "
                    f"differing {diff}; {card[1]:.1f}s card, {t_cpu:.1f}s CPU")
                if diff:
                    raise SystemExit(f"[{tag}] {name}: the card disagrees with the CPU")

            pending.append((f"{name} slice", row_slice, [(name, "cpu")], compare))
    return res, pending


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
    probe = phase_build()
    num_repeat = 12
    exp = (144, 0.004, num_repeat, 3, 1)
    _, _, dem, plan = build_bb_window_experiment(*exp)
    log(f"[setup] DEM {dem.chk.shape}, windows {[w.mat.shape for w in plan.windows]}")
    cn = phase_cn(plan)
    cnp = phase_cn_pinned(plan)
    bp4_cn = phase_bp4_cn()
    gj = phase_gj(plan)
    t0 = time.perf_counter()
    det, obs, _ = sample_dem_numpy(dem, REF_SHOTS, np.random.default_rng(SEED))
    log(f"[setup] sampled {REF_SHOTS} shots in {time.perf_counter() - t0:.1f}s")
    osd_cs = phase_osd_cs(plan, det)
    osd_e = phase_osd_e(plan, det)
    span = phase_bp_span(plan, det)
    main_res = phase_path("main", plan, det, obs,
                          window_decoder_factory(False, device="cuda", **FLAGSHIP_KNOBS),
                          num_repeat, (REF_FAILED, REF_SHOTS), REF_FAILED,
                          ("bp_span", "osd_cs_fused"))
    exp72 = (72, 0.01, 3, 2, 1)
    _, _, dem72, plan72 = build_bb_window_experiment(*exp72)
    det72, obs72, _ = sample_dem_numpy(dem72, 128, np.random.default_rng(SEED))
    pending = [phase_card_vs_cpu(  # the deferred CPU halves, run after the last phase
        "small", exp72, plan72, det72, obs72, "bposd",
        dict(max_iter=30, osd_order=2, phase_a_iters=None, phase_b_spans=None))]
    main_res.pop("e_hat")
    log(json.dumps({"main_path": main_res}))
    short_res = phase_path("osd_window", plan, det, obs,
                           window_decoder_factory(True, device="cuda"), num_repeat,
                           (REF_SHORT_FAILED, REF_SHORT_SHOTS), SHORT_FAILED,
                           ("bp_span_pinned", "osd_cs_fused"))
    pending += [
        phase_card_vs_cpu("osd_window_slice", exp, plan, det[:SLICE_SHOTS], obs[:SLICE_SHOTS],
                          "osd_window", {}),
        phase_card_vs_cpu("osd_window_small", exp72, plan72, det72, obs72, "osd_window",
                          dict(max_iter=30, osd_order=2))]
    short_res.pop("e_hat")
    log(json.dumps({"osd_window_path": short_res}))

    gexp = (144, GDG_P, num_repeat, 3, 1)
    _, _, gdem, gplan = build_bb_window_experiment(*gexp)
    gdet, gobs, _ = sample_dem_numpy(gdem, GDG_SHOTS, np.random.default_rng(SEED))
    gdg_burst = phase_bp_span_gdg(gplan, gdet, GDG_BUCKET)
    gdg_res = phase_path("gdg", gplan, gdet, gobs,
                         gdg_window_factory(max_iter=8, ensemble_bucket=GDG_BUCKET,
                                            device="cuda"),
                         num_repeat, (REF_GDG_FAILED, REF_GDG_SHOTS), GDG_FAILED,
                         ("bp_span", "bp_span_pinned"))
    gdg_res["ensemble_bucket"] = GDG_BUCKET
    k = GDG_SLICE_SHOTS
    pending += [
        phase_card_vs_cpu("gdg_slice", gexp, gplan, gdet[:k], gobs[:k], "gdg",
                          dict(max_iter=8, ensemble_bucket=GDG_SLICE_BUCKET)),
        phase_card_vs_cpu("gdg_small", exp72, plan72, det72, obs72, "gdg", dict(max_iter=8))]
    log(json.dumps({"gdg_path": {k: v for k, v in gdg_res.items() if k != "e_hat"}}))
    spans_res = phase_gdg_spans(gplan, gdet, gobs, num_repeat, gdg_res)
    log(json.dumps({"gdg_spans_path": spans_res}))
    bursts = {}
    bf16_res, half = phase_gdg_bf16(gexp, gplan, gdet, gobs, num_repeat, bursts)
    pending.append(half)
    log(json.dumps({"gdg_bf16_path": bf16_res}))
    serial_res, half = phase_gdg_serial(gexp, gplan, gdet)
    pending.append(half)
    log(json.dumps({"gdg_serial": serial_res}))

    from slidingwindowdecoder_torch.harness.code_capacity import parity_code

    code882 = parity_code(882)
    cc_synd = cc_samples(code882)
    phase_osd_882(code882, cc_synd[:CC_OSD_CHECK_SHOTS], gj, osd_cs)
    bpgd_burst = phase_bp_span_bpgd(code882, cc_synd[:CC_SHOTS])
    cc_res = phase_cc_host(code882)
    cc_dev = phase_cc_device(code882)
    pending += phase_cc_slice(cc_synd)
    log(json.dumps({"code_capacity": cc_res, "code_capacity_device": cc_dev}))

    captured, global_bp = {}, {}
    global_res = phase_global(captured, global_bp)
    log(json.dumps({"global": global_res}))
    wide_res, wide_checks = phase_sw_wide(captured)
    log(json.dumps({"sw_wide": wide_res}))
    span_wide = phase_bp_span_wide(global_bp)
    if set(captured) != {(936, 8784), (576, 4896)}:
        raise SystemExit("[gj_cluster] a path ran no OSD bucket at 936x8784 or 576x4896")
    gj_cluster = phase_gj_cluster(plan, captured[576, 4896], captured[936, 8784], probe)
    pending.append(phase_global_slice())
    _, _, wdem, wplan = build_bb_window_experiment(*GDG_WIDE_EXP)
    wdet, wobs, _ = sample_dem_numpy(wdem, GDG_WIDE_SLICE_SHOTS, np.random.default_rng(SEED))
    wide_gdg, wide_gdg_checks, half = phase_gdg_wide(bursts, wplan, wdet, wobs)
    pending.append(half)
    log(json.dumps({"gdg_wide": wide_gdg}))
    ring = phase_bp_span_bf16_ring((gplan, wplan), gdet, bursts)
    rows = {}
    for tag, names in (("bp4", ("bp4-osdcs", "camel-362")),
                       ("phenom", ("phenom-osd", "phenom-gdg")),
                       ("shyps", ("shyps-window", "shyps-global"))):
        rows[tag], halves = phase_rows(tag, names)
        pending += halves
        log(json.dumps({f"{tag}_rows": rows[tag]}))
    run_cpu_halves(pending)

    span_src = "slidingwindowdecoder_torch/csrc/bp_span.cu"
    cn_src = "slidingwindowdecoder_torch/csrc/cn_update.cu"
    gj_src = "slidingwindowdecoder_torch/csrc/gauss_jordan.cu"
    by_path = {k: {"main": main_res["launches"][k], "osd_window": short_res["launches"][k],
                   "gdg": gdg_res["launches"][k], "gdg_spans": spans_res["launches"][k],
                   "gdg_bf16": bf16_res["launches"][k], "gdg_serial": serial_res["launches"][k],
                   "gdg_wide": wide_gdg["launches"][k],
                   "code_capacity": sum(r["launches"][k] for r in (*cc_res.values(),
                                                                   *cc_dev.values())),
                   "global": sum(r["launches"][k] for r in global_res.values()),
                   "sw_wide": sum(r["launches"][k] for r in wide_res.values()),
                   **{tag: sum(r["launches"][k] for r in forms.values())
                      for tag, forms in rows.items()}}
               for k in main_res["launches"]}
    for res, name in ((span["bp_span"], "bp_span"), (osd_cs, "osd_cs_fused"),
                      (gj_cluster["osd_cs_fused_cluster"], "osd_cs_fused_cluster")):
        res["sw_wide"] = wide_checks[name]
        res["max_abs_err"] = max([res["max_abs_err"],
                                  *(r["max_abs_err"] for r in wide_checks[name].values())])
    # the wide route's kernels-line entries: the global decode's calls by
    # mode, each with the [[288]] W=4 interior windows' (unmasked f32)
    wide = {"bp_span_wide": {k: v for k, v in span_wide.items() if "pinned" not in k},
            "bp_span_wide_pinned": {k: v for k, v in span_wide.items() if "pinned" in k}}
    wide["bp_span_wide"].update(wide_checks["bp_span_wide"])
    for name, cases in wide.items():
        lead = max(cases.values(), key=lambda r: r["bound_ms"])  # the largest case leads
        wide[name] = {**{k: lead[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "shape")},
                      "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
                      "cases": cases}
    span["bp_span"]["gdg_wide"] = wide_gdg_checks
    span["bp_span_pinned"]["gdg_burst"] = gdg_burst
    span["bp_span_pinned"]["bpgd_burst"] = bpgd_burst
    span["bp_span_pinned"]["bf16_ring"] = {k: v for k, v in ring.items() if "GDG" in k}
    span["bp_span"]["bf16_ring"] = {k: v for k, v in ring.items() if "GDG" not in k}
    span["bp_span_pinned"]["max_abs_err"] = max(span["bp_span_pinned"]["max_abs_err"],
                                                gdg_burst["max_abs_err"],
                                                bpgd_burst["max_abs_err"])
    for name, counter, checks in (
            ("bp_span", "bp_span_bf16_ring", ("bf16_ring", "gdg_wide")),
            ("bp_span_pinned", "bp_span_pinned_bf16_ring", ("bf16_ring",))):
        span[name]["ring_dtypes"] = ["float32", "bfloat16"]
        span[name]["max_abs_err"] = max([span[name]["max_abs_err"], *(
            r["max_abs_err"] for c in checks for r in span[name][c].values())])
        span[name]["bf16_ring_launches"] = sum(by_path[counter].values())
        span[name]["bf16_ring_launches_by_path"] = by_path[counter]
    kernels = [
        {"name": "bp_span", "route": "cuda", "source": span_src,
         "replaces": "ops/bp_pallas.py:42 (_cn_kernel, JAX package) with the XLA ops "
                     "of ops/bp.py:172 (bp_run's iteration)",
         "launches": sum(by_path["bp_span"].values()), **span["bp_span"]},
        {"name": "bp_span_pinned", "route": "cuda", "source": span_src,
         "replaces": "ops/bp_pallas.py:42 (_cn_kernel with pinned=True, JAX package) with "
                     "the XLA ops of ops/bp.py:172 (masked bp_run's iteration)",
         "launches": sum(by_path["bp_span_pinned"].values()), **span["bp_span_pinned"]},
        {"name": "bp_span_wide", "route": "cuda", "source": span_src,
         "replaces": "ops/bp_pallas.py:42 (_cn_kernel, JAX package) with the XLA ops "
                     "of ops/bp.py:172 (bp_run's iteration), on graphs whose tables and "
                     "messages do not fit one block together",
         "launches": sum(by_path["bp_span_wide"].values()), **wide["bp_span_wide"]},
        {"name": "bp_span_wide_pinned", "route": "cuda", "source": span_src,
         "replaces": "ops/bp_pallas.py:42 (_cn_kernel with pinned=True, JAX package) with "
                     "the XLA ops of ops/bp.py:172 (masked bp_run's iteration), on graphs "
                     "whose tables and messages do not fit one block together",
         "launches": sum(by_path["bp_span_wide_pinned"].values()),
         **wide["bp_span_wide_pinned"]},
        {"name": "cn_update", "route": "cuda", "source": cn_src,
         "replaces": "ops/bp_pallas.py:42 (_cn_kernel, JAX package); BP4's CN stage, "
                     "ops/bp4.py:33 (_cn_minsum_bm, the same two-pass min-sum in XLA)",
         "launches": sum(by_path["cn_update"].values()), "bound_by": "bytes",
         **cn, "bp4": {k: v for k, v in bp4_cn.items() if k != "max_abs_err"},
         "max_abs_err": max(cn["max_abs_err"], bp4_cn["max_abs_err"])},
        {"name": "cn_update_pinned", "route": "cuda", "source": cn_src,
         "replaces": "ops/bp_pallas.py:42 (_cn_kernel with pinned=True, JAX package)",
         "launches": sum(by_path["cn_update_pinned"].values()), "bound_by": "bytes", **cnp},
        {"name": "gauss_jordan_key", "route": "cuda", "source": gj_src,
         "replaces": "ops/gf2_pallas.py:54 (_gj_kernel, JAX package)",
         "launches": sum(by_path["gauss_jordan_key"].values()), **gj, "osd_e": osd_e,
         "max_abs_err": max(gj["max_abs_err"], osd_e["max_abs_err"])},
        {"name": "osd_cs_fused", "route": "cuda", "source": gj_src,
         "replaces": "ops/gf2_pallas.py:54 (_gj_kernel, JAX package) with the XLA "
                     "ops/gf2_solve.py:215 (ordered_gauss_jordan_key) and :522 "
                     "(_osd_sweep_cs_sortless)",
         "launches": sum(by_path["osd_cs_fused"].values()), **osd_cs},
        {"name": "gauss_jordan_key_cluster", "route": "cuda", "source": gj_src,
         "replaces": "ops/gf2_pallas.py:54 (_gj_kernel, JAX package) and the XLA "
                     "ops/gf2_solve.py:215 (ordered_gauss_jordan_key) at shapes beyond one "
                     "block",
         "launches": sum(by_path["gauss_jordan_key_cluster"].values()),
         **gj_cluster["gauss_jordan_key_cluster"]},
        {"name": "osd_cs_fused_cluster", "route": "cuda", "source": gj_src,
         "replaces": "ops/gf2_pallas.py:54 (_gj_kernel, JAX package) with the XLA "
                     "ops/gf2_solve.py:215 (ordered_gauss_jordan_key) and :522 "
                     "(_osd_sweep_cs_sortless) at shapes beyond one block",
         "launches": sum(by_path["osd_cs_fused_cluster"].values()),
         **gj_cluster["osd_cs_fused_cluster"]},
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
