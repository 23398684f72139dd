#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's decode paths (one CUDA card).

Decodes the [[144,12,12]] W=3 sliding-window experiment (p=0.004, 12
rounds) once to warm up, once timed, once with per-stage host timers
(each stage ends in a synchronize) and once under ``torch.profiler`` for
kernel times and the device's busy share.

    python3 tools/torch_profile_main_path.py                  # BPOSD flagship
    python3 tools/torch_profile_main_path.py --path osd_window

``bposd``: BP+OSD-CS-10 with the bench knobs and bf16 messages; stages
phase A, phase B, OSD. ``osd_window``: the shortened ``OSDWindow`` decode
(pre-BP 8, post-BP 200, OSD-CS-10, f32); stages pre-BP, peel sweeps,
post-BP buckets, OSD. Prints one JSON line with the stage seconds and the
kernel launches of the timed decode, then one with the top kernels by
device time, the busy share, and the OSD stage's device time (the kernels
launched inside ``osd_decode``) beside its host time (the same calls'
CPU time), both from the profiled decode. 16384 shots from seed 2024, as
``chip_smoke.py``.
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


SHOTS, SEED = 16384, 2024
OSD_STAGE = "osd_decode (fused GJ + CS kernel)"


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("bposd", "osd_window"), default="bposd")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.decoders import BPOSD, bposd, osd_window
    from slidingwindowdecoder_torch.harness.circuit_level import (
        build_bb_window_experiment,
        window_decoder_factory,
    )
    from slidingwindowdecoder_torch.ops import bp_cuda, decimation, gf2_cuda
    from slidingwindowdecoder_torch.windows.pipeline import decode_sliding_window

    _, _, dem, plan = build_bb_window_experiment(144, 0.004, 12, 3, 1)
    det, _, _ = sample_dem_numpy(dem, SHOTS, np.random.default_rng(SEED))
    det = torch.as_tensor(det, device="cuda")
    # (owner, attribute, stage name from the call's arguments) to time
    if args.path == "bposd":
        factory = window_decoder_factory(
            False, bp_bucket=1024, osd_bucket=256, phase_a_iters=16,
            phase_b_spans=(48, 136), msg_dtype="bfloat16", device="cuda")
        patches = [
            (BPOSD, "_run_bp", lambda self, mv, synds, *_, **__: (
                "bp phase A (full batch)" if synds.shape[0] == SHOTS
                else "bp phase B (buckets)")),
            (bposd, "osd_decode", lambda *a, **k: OSD_STAGE),
        ]
    else:
        factory = window_decoder_factory(True, device="cuda")
        patches = [
            (osd_window, "bp_run", lambda garr, mv, prior, synds, *_, **__: (
                "pre-BP (full batch)" if synds.shape[0] == SHOTS
                else "post-BP (buckets)")),
            (decimation, "_sweep", lambda *a: "peel sweeps"),
            (osd_window, "osd_decode", lambda *a, **k: OSD_STAGE),
        ]

    def run():
        out = decode_sliding_window(plan, det, factory, device="cuda", verbose=False,
                                    collect_window_stats=False)
        torch.cuda.synchronize()
        return out

    run()  # warm-up: cuBLAS handles, caching allocator, kernel libraries
    cn, span = bp_cuda.cn_update, bp_cuda.bp_span
    gj, osd = gf2_cuda.gauss_jordan_key, gf2_cuda.osd_cs_fused
    for k in (cn, span, gj, osd):
        k.launches = 0
    cn.pinned_launches = span.pinned_launches = 0
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    launches = {"bp_span": span.launches, "bp_span_pinned": span.pinned_launches,
                "cn_update": cn.launches, "cn_update_pinned": cn.pinned_launches,
                "gauss_jordan_key": gj.launches, "osd_cs_fused": osd.launches}

    # per-stage wall time: wrap the decoder's stages with synchronizing timers
    stages = defaultdict(float)
    calls = defaultdict(int)

    def timed(name_of, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            name = name_of(*a, **k)
            stages[name] += time.perf_counter() - t0
            calls[name] += 1
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
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "path": args.path, "shots": SHOTS,
        "wall_s": wall, "shots_per_s": SHOTS / wall, "staged_wall_s": total,
        "stages_s": dict(stages), "stage_calls": dict(calls), "launches": launches,
    }), flush=True)

    # the OSD stage as one profiler range: its kernels' device time and its
    # calls' CPU time
    osd_owner = patches[-1][0]
    osd_fn = osd_owner.osd_decode

    def osd_ranged(*a, **k):
        with record_function(OSD_STAGE):
            return osd_fn(*a, **k)

    osd_owner.osd_decode = osd_ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            prof_wall = time.perf_counter() - t0
    finally:
        osd_owner.osd_decode = osd_fn
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
    osd_cpu = [e for e in events if e.key == OSD_STAGE and e.device_type == DeviceType.CPU]
    osd_dev = [e for e in events if e.key == OSD_STAGE and e.device_type == DeviceType.CUDA]
    osd_stage = {
        "calls": sum(e.count for e in osd_cpu),
        "host_cpu_s": sum(float(e.cpu_time_total) for e in osd_cpu) / 1e6,
        "device_span_s": sum(dev_us(e) for e in osd_dev) / 1e6,
    }

    # device-side events only (the kernels and memcpys themselves): the
    # aten operator rows repeat the time of the kernels they launch
    kernels = sorted(
        ((e.key, dev_us(e), e.count) for e in events
         if e.device_type == DeviceType.CUDA and dev_us(e) > 0 and e.key != OSD_STAGE),
        key=lambda x: -x[1],
    )
    busy_us = sum(k[1] for k in kernels)

    result = {
        "unprofiled_wall_s": wall,
        "profiled_wall_s": prof_wall,
        "device_busy_s": busy_us / 1e6,
        # share of the profiled run's wall time with no kernel running
        # (the profiler slows the host, so this overstates the idle share
        # of an unprofiled run, where busy / wall_s is the estimate)
        "device_idle_share": 1 - busy_us / 1e6 / prof_wall,
        "device_busy_over_unprofiled_wall": busy_us / 1e6 / wall,
        "osd_stage_profiled": osd_stage,
        "top_kernels": [
            {"name": k[0][:80], "device_ms": k[1] / 1e3, "count": k[2]}
            for k in kernels[:20]
        ],
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
