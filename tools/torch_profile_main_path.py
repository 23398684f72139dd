#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main path (one CUDA card).

Decodes the [[144,12,12]] W=3 sliding-window experiment (p=0.004, 12
rounds, bench knobs, bf16 messages) once to warm up, once timed, once
with per-stage host timers (each stage ends in a synchronize) and once
under ``torch.profiler`` for kernel times and the device's busy share.

    python3 tools/torch_profile_main_path.py

Prints one JSON line with the stage seconds, the top kernels by device
time and the busy share. 16384 shots from seed 2024, as ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


SHOTS, SEED = 16384, 2024


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from slidingwindowdecoder_torch.circuits import sample_dem_numpy
    from slidingwindowdecoder_torch.decoders import BPOSD, bposd
    from slidingwindowdecoder_torch.harness.circuit_level import build_bb_window_experiment
    from slidingwindowdecoder_torch.windows.pipeline import (
        CachingDecoderFactory,
        decode_sliding_window,
    )

    _, _, dem, plan = build_bb_window_experiment(144, 0.004, 12, 3, 1)
    det, _, _ = sample_dem_numpy(dem, SHOTS, np.random.default_rng(SEED))
    det = torch.as_tensor(det, device="cuda")
    factory = CachingDecoderFactory(lambda spec: BPOSD(
        spec.mat, spec.prior, max_iter=200, osd_method="osd_cs", osd_order=10,
        bp_bucket=1024, osd_bucket=256, phase_a_iters=16, phase_b_spans=(48, 136),
        msg_dtype="bfloat16", device="cuda"))

    def run():
        out = decode_sliding_window(plan, det, factory, device="cuda", verbose=False,
                                    collect_window_stats=False)
        torch.cuda.synchronize()
        return out

    run()  # warm-up: cuBLAS handles, caching allocator, kernel libraries
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0

    # per-stage wall time: wrap the decoder's stages with synchronizing timers
    stages = defaultdict(float)
    calls = defaultdict(int)

    def timed(name_of, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            name = name_of(*a)
            stages[name] += time.perf_counter() - t0
            calls[name] += 1
            return r
        return wrapper

    def bp_stage(self, mv, synds, *rest):
        return ("bp phase A (full batch)" if synds.shape[0] == SHOTS
                else "bp phase B (buckets)")

    orig_run_bp, orig_osd = BPOSD._run_bp, bposd.osd_decode
    BPOSD._run_bp = timed(bp_stage, orig_run_bp)
    bposd.osd_decode = timed(lambda *a: "osd_decode (GJ kernel + CS sweep)", orig_osd)
    try:
        t0 = time.perf_counter()
        run()
        total = time.perf_counter() - t0
    finally:
        BPOSD._run_bp, bposd.osd_decode = orig_run_bp, orig_osd
    stages["other (pipeline, sort, gather/scatter)"] = total - sum(stages.values())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v is not None:
                return float(v)
        return 0.0

    # device-side events only (the kernels and memcpys themselves): the
    # aten operator rows repeat the time of the kernels they launch
    kernels = sorted(
        ((e.key, dev_us(e), e.count) for e in events
         if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
        key=lambda x: -x[1],
    )
    busy_us = sum(k[1] for k in kernels)

    result = {
        "device": torch.cuda.get_device_name(0),
        "shots": SHOTS,
        "wall_s": wall,
        "shots_per_s": SHOTS / wall,
        "staged_wall_s": total,
        "stages_s": dict(stages),
        "stage_calls": dict(calls),
        "profiled_wall_s": prof_wall,
        "device_busy_s": busy_us / 1e6,
        # share of the profiled run's wall time with no kernel running
        # (the profiler slows the host, so this overstates the idle share
        # of an unprofiled run, where busy / wall_s is the estimate)
        "device_idle_share": 1 - busy_us / 1e6 / prof_wall,
        "device_busy_over_unprofiled_wall": busy_us / 1e6 / wall,
        "top_kernels": [
            {"name": k[0][:80], "device_ms": k[1] / 1e3, "count": k[2]}
            for k in kernels[:20]
        ],
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
