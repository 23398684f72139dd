#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's decode paths (one CUDA card).

Decodes the [[144,12,12]] W=3 sliding-window experiment (12 rounds) once
to warm up, once timed, once with per-stage host timers (each stage ends
in a synchronize; a stage's time excludes the timed stages it calls) and
once under ``torch.profiler`` for kernel times and the device's busy
share.

    python3 tools/torch_profile_main_path.py                  # BPOSD flagship
    python3 tools/torch_profile_main_path.py --path osd_window
    python3 tools/torch_profile_main_path.py --path gdg [--gdg-bucket 256]
    python3 tools/torch_profile_main_path.py --path gdg_spans
    python3 tools/torch_profile_main_path.py --path gdg_288_41
    python3 tools/torch_profile_main_path.py --path cc_bpgd
    python3 tools/torch_profile_main_path.py --path global

``bposd``: BP+OSD-CS-10 with the bench knobs and bf16 messages; stages
phase A, phase B, OSD. ``osd_window``: the shortened ``OSDWindow`` decode
(pre-BP 8, post-BP 200, OSD-CS-10, f32); stages pre-BP, peel sweeps,
post-BP buckets, OSD. Both at p=0.004 over 16384 shots. ``gdg``: the
``sliding_window_gdg`` decoder (pre-BP 8, the GDG defaults, f32) at
p=0.005 over 8192 shots; stages pre-BP, shortening, ensemble set-up, BP
bursts, select and aggressive decimation, the guess's ``vn_set_values_t``,
the transposed peels (sweeps, each ending in one host read), reduce.
``gdg_spans``: the same decoder with ``ensemble_mode="spans"`` (row buckets
of 2048 at most, lane dormancy); its stages add the compaction's gathers.
``gdg_288_41``: the gdg-288-41 parity row's decoder ([[288,12,18]], 18
rounds, (W,F) = (4,1), p=0.005; pre-BP 16, 60 steps, tree 4 / side 20,
branch steps 40: 47 branches; the JAX tool's knobs, bf16 messages and
ring, spans form, 512-shot buckets) over its first 512 shots (one bucket
a window, as in the row's 4096-shot decode); stages as ``gdg_spans``; no
``torch.profiler`` run (it ran over 14 minutes on this decode's ~3100
steps), so no device time or busy share.
``cc_bpgd``: code capacity on the [[882,24]] QC-GHP code at p=0.04, one
``BPGD.core`` call on 65536 syndromes (the first batch that
``data_qubit_noise_decoding`` draws from seed 2024 at that batch size):
no pre-BP, 12 masked iterations a step at ``gd_factor`` 0.8, max_step
100, spans mode; stages the bursts, the decision's ``vn_set_values``, the
peels (sweeps, a host read each) and the rest (the argmax, the step's
finished read, the compaction). ``global``: ``global_decoder``'s decoder
(BP+OSD-CS-10 with the bench knobs and bf16 messages) on the whole [[144]]
DEM (936x8784) at p=0.004, 16384 shots in two 8192-shot ``core`` calls as
``global_decoder`` chunks them; stages as ``bposd`` (BP runs the per-op
loop with ``cn_update.cu``, OSD the cluster route of kernel B); the
profiled decode covers the first chunk. Seed 2024, as ``chip_smoke.py``.

Prints one JSON line with the stage seconds and the kernel launches of the
timed decode, then one with the top kernels by device time, the busy
share, and one stage's device time (the kernels launched inside it)
beside its host time (the same calls' CPU time), both from the profiled
decode: OSD on the first two paths, the BP bursts on the others.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


SEED = 2024
OSD_STAGE = "osd_decode (fused GJ + CS kernel)"
BURST_STAGE = "ensemble bursts (masked bp_run, one bp_span_pinned launch each)"
PROFILED_GDG_SHOTS = 1024
# the gdg-288-41 row (tools/torch_validate_circuit_level.py): experiment
# (N, p, rounds, W, F), shots (one ensemble bucket a window) and GDG knobs
GDG_288_EXP, GDG_288_SHOTS = (288, 0.005, 18, 4, 1), 512
GDG_288_KNOBS = dict(max_iter=16, max_step=60, max_tree_depth=4, max_side_depth=20,
                     max_tree_branch_step=40, max_side_branch_step=40, msg_dtype="bfloat16",
                     hist_dtype="bfloat16", ensemble_mode="spans")
PROFILED_CC_SHOTS = 16384
CC_SHOTS, CC_P = 65536, 0.04
GLOBAL_BATCH = 8192




def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("bposd", "osd_window", "gdg", "gdg_spans", "gdg_288_41",
                                       "cc_bpgd", "global"), default="bposd")
    ap.add_argument("--gdg-bucket", type=int, default=512,
                    help="GDG ensemble_bucket (shots per ensemble bucket)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.decoders import (
        BPGD,
        BPOSD,
        GDG,
        bpgd,
        bposd,
        gdg,
        osd_window,
    )
    from slidingwindowdecoder_torch.harness.circuit_level import (
        build_bb_window_experiment,
        build_global_decoder,
        gdg_window_factory,
        window_decoder_factory,
    )
    from slidingwindowdecoder_torch.harness.code_capacity import parity_code, parity_decoder
    from slidingwindowdecoder_torch.ops import bp_cuda, decimation, gf2_cuda
    from slidingwindowdecoder_torch.windows.pipeline import decode_sliding_window

    gdg_paths = ("gdg", "gdg_spans", "gdg_288_41")
    if args.path == "cc_bpgd":
        code = parity_code(882)
        shots = CC_SHOTS
        rng = np.random.default_rng(SEED)
        err = (rng.random((shots, code.N)) < CC_P).astype(np.float32)
        det = torch.as_tensor(((err @ code.hx.T.astype(np.float32)) % 2).astype(np.uint8),
                              device="cuda")
        dec = parity_decoder(code, CC_P, "bpgd", {"max_step": 100}, device="cuda")
    else:
        exp, shots = {"gdg_288_41": (GDG_288_EXP, GDG_288_SHOTS),
                      "gdg": ((144, 0.005, 12, 3, 1), 8192),
                      "gdg_spans": ((144, 0.005, 12, 3, 1), 8192)}.get(
                          args.path, ((144, 0.004, 12, 3, 1), 16384))
        _, _, dem, plan = build_bb_window_experiment(*exp)
        det, _, _ = sample_dem_numpy(dem, shots, np.random.default_rng(SEED))
        det = torch.as_tensor(det, device="cuda")
        if args.path == "global":
            dec = build_global_decoder(dem, device="cuda")
    # (owner, attribute, stage name from the call's arguments) to time; the
    # last one is also the profiled stage
    ranged = OSD_STAGE
    if args.path == "cc_bpgd":
        ranged = BURST_STAGE
        patches = [
            (BPGD, "_shorten_state", lambda *a: "shortening (nothing to drop: new_n = n)"),
            (bpgd, "vn_set_values", lambda *a: "vn_set_values (the decision)"),
            (bpgd, "peel", lambda *a: "peel (sweeps and host reads)"),
            (bpgd, "bp_run", lambda *a, **k: BURST_STAGE),
        ]
    elif args.path in gdg_paths:
        knobs = {"gdg": dict(max_iter=8, ensemble_mode="fused"),
                 "gdg_spans": dict(max_iter=8, ensemble_mode="spans"),
                 "gdg_288_41": GDG_288_KNOBS}[args.path]
        factory = gdg_window_factory(ensemble_bucket=args.gdg_bucket, device="cuda", **knobs)
        ranged = BURST_STAGE
        patches = [
            (gdg, "_take_cols", lambda *a: "compaction and activation gathers"),
            (gdg, "decode_bp", lambda *a, **k: "pre-BP (whole batch, unmasked)"),
            (GDG, "_shorten_state", lambda *a: "shortening (sort, vn_set_values, peel)"),
            (gdg, "_ensemble_init", lambda *a, **k: "ensemble set-up (tiling)"),
            (gdg, "_select_and_decimate_t",
             lambda *a, **k: "select and aggressive decimation (num_flip, C/D/A, guess)"),
            (gdg, "vn_set_values_t", lambda *a: "vn_set_values_t (aggressive set, guess)"),
            (gdg, "peel_t", lambda *a, **k: "peel_t (sweeps and host reads)"),
            (gdg, "_ensemble_reduce", lambda *a: "reduce"),
            (gdg, "bp_run", lambda *a, **k: BURST_STAGE),
        ]
    elif args.path in ("bposd", "global"):
        factory = window_decoder_factory(
            False, bp_bucket=1024, osd_bucket=256, phase_a_iters=16,
            phase_b_spans=(48, 136), msg_dtype="bfloat16", device="cuda")
        full = GLOBAL_BATCH if args.path == "global" else shots
        patches = [
            (BPOSD, "_run_bp", lambda self, mv, synds, *_, **__: (
                "bp phase A (full batch)" if synds.shape[0] == full
                else "bp phase B (buckets)")),
            (bposd, "osd_decode", lambda *a, **k: OSD_STAGE),
        ]
    else:
        factory = window_decoder_factory(True, device="cuda")
        patches = [
            (osd_window, "bp_run", lambda garr, mv, prior, synds, *_, **__: (
                "pre-BP (full batch)" if synds.shape[0] == shots
                else "post-BP (buckets)")),
            (decimation, "_sweep", lambda *a: "peel sweeps"),
            (osd_window, "osd_decode", lambda *a, **k: OSD_STAGE),
        ]

    sweeps = [0]
    sweep_name = "_sweep" if args.path == "cc_bpgd" else "_sweep_t"
    sweep_fn = getattr(decimation, sweep_name)

    def counted_sweep(*a, **k):
        sweeps[0] += 1
        return sweep_fn(*a, **k)

    setattr(decimation, sweep_name, counted_sweep)

    def run(d=det):
        if args.path == "cc_bpgd":
            out = dec.core(d)
        elif args.path == "global":
            out = [dec.core(d[lo:lo + GLOBAL_BATCH]) for lo in range(0, len(d), GLOBAL_BATCH)]
        else:
            out = decode_sliding_window(plan, d, factory, device="cuda", verbose=False,
                                        collect_window_stats=False)
        torch.cuda.synchronize()
        return out

    run()  # warm-up: cuBLAS handles, caching allocator, kernel libraries
    cn, span = bp_cuda.cn_update, bp_cuda.bp_span
    gj, osd = gf2_cuda.gauss_jordan_key, gf2_cuda.osd_cs_fused
    for k in (cn, span, gj, osd):
        k.launches = 0
    cn.pinned_launches = span.pinned_launches = gj.cluster_launches = osd.cluster_launches = 0
    span.bf16_ring_launches = span.pinned_bf16_ring_launches = 0
    sweeps[0] = 0
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    launches = {"bp_span": span.launches, "bp_span_pinned": span.pinned_launches,
                "bp_span_bf16_ring": span.bf16_ring_launches,
                "bp_span_pinned_bf16_ring": span.pinned_bf16_ring_launches,
                "cn_update": cn.launches, "cn_update_pinned": cn.pinned_launches,
                "gauss_jordan_key": gj.launches, "osd_cs_fused": osd.launches,
                "gauss_jordan_key_cluster": gj.cluster_launches,
                "osd_cs_fused_cluster": osd.cluster_launches}
    n_sweeps = sweeps[0]

    # per-stage wall time: wrap the decoder's stages with synchronizing
    # timers; a stage's time excludes that of the timed stages it calls
    stages = defaultdict(float)
    calls = defaultdict(int)
    inner = []  # per open timed call: the time spent in timed calls inside it

    def timed(name_of, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner.append(0.0)
            r = fn(*a, **k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            name = name_of(*a, **k)
            stages[name] += dt - inner.pop()
            calls[name] += 1
            if inner:
                inner[-1] += dt
            return r
        return wrapper

    originals = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    for (owner, attr, name_of), (_, _, fn) in zip(patches, originals):
        setattr(owner, attr, timed(name_of, fn))
    try:
        t0 = time.perf_counter()
        run()
        total = time.perf_counter() - t0
    finally:
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)
    stages["other (pipeline, sort, gather/scatter)"] = total - sum(stages.values())
    res = {
        "device": torch.cuda.get_device_name(0), "path": args.path, "shots": shots,
        "wall_s": wall, "shots_per_s": shots / wall, "staged_wall_s": total,
        "stages_s": dict(stages), "stage_calls": dict(calls), "launches": launches,
    }
    if args.path in gdg_paths:
        res.update(gdg_bucket=args.gdg_bucket, peel_sweeps=n_sweeps)
    elif args.path == "cc_bpgd":
        # host reads: one per peel sweep, one per step (whether every row
        # halted; a burst is one step), one per span (rows left)
        res.update(peel_sweeps=n_sweeps, bursts=launches["bp_span_pinned"],
                   spans=len(dec.decim_spans))
    print(json.dumps(res), flush=True)
    if args.path == "gdg_288_41":
        return 0

    # the ranged stage as one profiler range: its kernels' device time and
    # its calls' CPU time
    r_owner, r_attr, _ = patches[-1]
    r_fn = getattr(r_owner, r_attr)

    def stage_ranged(*a, **k):
        with record_function(ranged):
            return r_fn(*a, **k)

    setattr(r_owner, r_attr, stage_ranged)
    # the profiler's cost grows with the op count: on the GDG paths it
    # traces the first PROFILED_GDG_SHOTS shots (two full ensemble buckets
    # a window at the default bucket), on cc_bpgd PROFILED_CC_SHOTS, on
    # global its first chunk, the others the whole batch
    prof_shots = {"gdg": PROFILED_GDG_SHOTS, "gdg_spans": PROFILED_GDG_SHOTS,
                  "cc_bpgd": PROFILED_CC_SHOTS, "global": GLOBAL_BATCH}.get(args.path, shots)
    sub_wall = wall
    if prof_shots < shots:  # the same shots unprofiled, for the busy share
        t0 = time.perf_counter()
        run(det[:prof_shots])
        sub_wall = time.perf_counter() - t0
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(det[:prof_shots])
            prof_wall = time.perf_counter() - t0
    finally:
        setattr(r_owner, r_attr, r_fn)
    events = prof.key_averages()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    # the range appears twice: as the CPU op (its calls' host time) and as a
    # user annotation on the card's timeline (its span there, which holds
    # the stage's kernels and any idle gap between them)
    r_cpu = [e for e in events if e.key == ranged and e.device_type == DeviceType.CPU]
    r_dev = [e for e in events if e.key == ranged and e.device_type == DeviceType.CUDA]
    r_stage = {
        "stage": ranged,
        "calls": sum(e.count for e in r_cpu),
        "host_cpu_s": sum(float(e.cpu_time_total) for e in r_cpu) / 1e6,
        "device_span_s": sum(dev_us(e) for e in r_dev) / 1e6,
    }

    # device-side events only (the kernels and memcpys themselves): the
    # aten operator rows repeat the time of the kernels they launch
    kernels = sorted(
        ((e.key, dev_us(e), e.count) for e in events
         if e.device_type == DeviceType.CUDA and dev_us(e) > 0 and e.key != ranged),
        key=lambda x: -x[1],
    )
    busy_us = sum(k[1] for k in kernels)

    result = {
        "profiled_shots": prof_shots,
        "unprofiled_wall_s": wall,
        "profiled_wall_s": prof_wall,
        "device_busy_s": busy_us / 1e6,
        # share of the profiled run's wall time with no kernel running
        # (the profiler slows the host, so this overstates the idle share
        # of an unprofiled run, where busy / wall_s is the estimate)
        "device_idle_share": 1 - busy_us / 1e6 / prof_wall,
        "unprofiled_wall_same_shots_s": sub_wall,
        "device_busy_over_unprofiled_wall": busy_us / 1e6 / sub_wall,
        "stage_profiled": r_stage,
        "top_kernels": [
            {"name": k[0][:80], "device_ms": k[1] / 1e3, "count": k[2]}
            for k in kernels[:20]
        ],
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
