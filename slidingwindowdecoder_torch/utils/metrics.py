"""Structured metrics and result artifacts (a copy of the JAX package's
``utils/metrics.py``, which uses numpy and the standard library only).

Replaces the reference's bare prints (osd.py:176-194) with counters,
throughput gauges, and JSON result files; binomial confidence intervals
back the statistical LER-parity tests.
"""

from __future__ import annotations

import json
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np


def wilson_interval(errors: int, shots: int, z: float = 1.96):
    """Wilson score interval for a binomial rate (good at small counts)."""
    if shots == 0:
        return (0.0, 1.0)
    p = errors / shots
    denom = 1 + z * z / shots
    center = (p + z * z / (2 * shots)) / denom
    half = (
        z * math.sqrt(p * (1 - p) / shots + z * z / (4 * shots * shots)) / denom
    )
    return (max(0.0, center - half), min(1.0, center + half))


def ler_per_round(p_l: float, num_rounds: int) -> float:
    return 1 - (1 - p_l) ** (1 / num_rounds)


def rates_compatible(err_a, shots_a, err_b, shots_b, z: float = 3.0) -> bool:
    """Are two binomial observations consistent (z-sigma two-proportion)?"""
    if shots_a == 0 or shots_b == 0:
        return True
    pa, pb = err_a / shots_a, err_b / shots_b
    pool = (err_a + err_b) / (shots_a + shots_b)
    var = pool * (1 - pool) * (1 / shots_a + 1 / shots_b)
    if var == 0:
        return pa == pb
    return abs(pa - pb) <= z * math.sqrt(var)


@dataclass
class RunMetrics:
    """Accumulating counters + timing for a Monte-Carlo run."""

    counters: dict = field(default_factory=dict)
    started: float = field(default_factory=time.perf_counter)
    spans: dict = field(default_factory=dict)
    window_seconds: list = field(default_factory=list)
    window_nonconverged: list = field(default_factory=list)

    def add(self, **kwargs):
        for k, v in kwargs.items():
            self.counters[k] = self.counters.get(k, 0) + v

    def add_window_stats(self, seconds, nonconverged=None):
        """Record per-window wall times (and optional non-converged counts)
        for tail-latency percentiles (reference FAQ.md:42 methodology)."""
        self.window_seconds.extend(float(s) for s in seconds)
        if nonconverged is not None:
            self.window_nonconverged.extend(int(c) for c in nonconverged)

    def time_span(self, name: str):
        metrics = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                metrics.spans[name] = metrics.spans.get(name, 0.0) + (
                    time.perf_counter() - self.t0
                )

        return _Span()

    def summary(self) -> dict:
        shots = self.counters.get("shots", 0)
        failed = self.counters.get("failed", 0)
        elapsed = time.perf_counter() - self.started
        out = {
            **self.counters,
            "elapsed_seconds": elapsed,
            "shots_per_sec": shots / max(elapsed, 1e-9),
            "spans": dict(self.spans),
        }
        if shots:
            out["ler"] = failed / shots
            out["ler_ci95"] = wilson_interval(failed, shots)
        if self.window_seconds:
            ws = np.asarray(self.window_seconds)
            out["window_p50_s"] = float(np.percentile(ws, 50))
            out["window_p99_s"] = float(np.percentile(ws, 99))
            out["window_worst_s"] = float(ws.max())
        if self.window_nonconverged and shots:
            nc = np.asarray(self.window_nonconverged, dtype=np.float64)
            out["nonconverged_per_window_mean"] = float(nc.mean())
        return out

    def write_json(self, path: str, extra: dict | None = None):
        payload = self.summary()
        if extra:
            payload.update(extra)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        return payload
