"""One run of one benchmark cell of the port ``slidingwindowdecoder_torch``.

A cell is a configuration (``configs/<name>.json``: the code, rounds,
windows, the decoder and its knobs, the program adapter in
``programs/<decoder>.py`` and the plain reference in
``reference/<decoder>.py``) under a traffic mix (``traffic/<name>.json``:
the noise rate, the batch, the pool of batches, the checked sample and the
traced batches), with the limit of its correctness check in
``limits/<cell>.json``. Each metric is read by ``metrics/<name>.py``.

A run: build the DEM (``dem.py``) and sample a pool of distinct batches on
the device from the seed (``sampler.py``); build the program's window plan
and factory; decode one batch to warm up. Then, with ``trace`` off, a
closed loop of one worker: batch after batch through the port's
``decode_sliding_window(sync_per_window=True)`` and
``evaluate_logical_errors`` until ``seconds`` have passed, every window
timed by the pipeline's own ``window_seconds`` (from before its decoder
is made to after the synchronise that ends it). With
``trace`` on, ``trace_batches`` batches three times: under
``torch.profiler`` with the benchmark's spans as ranges, with
synchronised spans, and with the work counters. Last, the program's state
is freed and the plain reference decodes a sample of the shots drawn from
the seed; the share of sampled shots whose correction or verdict differs
is held to the cell's limit.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import trace as tr
from .dem import build_dem
from .profile_read import read_profile
from .sampler import sample_pool
from .wilson import wilson_interval

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "slidingwindowdecoder_tpu"}
TRACE_WINDOW = "trace_window"


@dataclass
class Run:
    """What the metric readers read."""
    shots: int = 0
    failures: int = 0
    window_s: float = 0.0
    window_times_s: list = field(default_factory=list)
    setup_s: float = 0.0
    batches: int = 0
    spans: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    profile: dict = field(default_factory=dict)


def load_cell(workload: str, bench_file: Path = ROOT / "BENCHMARK.json") -> dict:
    bench = json.loads(Path(bench_file).read_text())
    base = Path(bench_file).parent
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in {bench_file}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def in_cell(m):
        return workload in m.get("workloads", [workload])

    return {
        "name": workload,
        "chips": cell["chips"],
        "config": json.loads((base / cfg_entry["file"]).read_text()),
        "traffic": json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((BENCH_DIR / "limits" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if in_cell(m)],
        "per_layer": [m for m in bench["per_layer"] if in_cell(m)],
    }


def read_metric(name: str, run: Run):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  BENCH_DIR / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def check_rows(seed: int, batch_index: int, shots: int, k: int) -> np.ndarray:
    """The shots of batch ``batch_index`` that the check samples."""
    if k >= shots:
        return np.arange(shots)
    rng = np.random.default_rng([seed, batch_index])
    return np.sort(rng.choice(shots, size=k, replace=False))


class Instrumented:
    """The factory with spans: a profiler range per window (profiled pass
    only) and a span around every ``core`` call, which also feeds the work
    counter and resets the program adapter's per-call state."""

    def __init__(self, factory, spans, state, counter=None):
        self.factory, self.spans, self.state, self.counter = factory, spans, state, counter
        self.window = None

    def close_window(self):
        if self.window is not None:
            self.window.__exit__(None, None, None)
            self.window = None

    def __call__(self, spec):
        self.close_window()
        if self.spans.mode == "profiled":
            self.window = self.spans.span("window")
            self.window.__enter__()
        dec = self.factory(spec)
        outer = self

        class Core:
            def core(self, synd):
                outer.state["core_calls"] = 0
                out = outer.spans.wrap(lambda *_: "core", dec.core)(synd)
                if outer.counter is not None:
                    outer.counter.count_core(out)
                return out

        return Core()


class Cell:
    """The program's side of one run."""

    def __init__(self, cell: dict, seed: int, device: torch.device):
        from slidingwindowdecoder_torch.windows.pipeline import (
            decode_sliding_window,
            evaluate_logical_errors,
        )
        from slidingwindowdecoder_torch.windows.regions import build_sliding_window_plan

        self.decode_sliding_window = decode_sliding_window
        self.evaluate = evaluate_logical_errors
        cfg, traffic = self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.device, self.cuda = seed, device, device.type == "cuda"
        self.dem = build_dem(cfg["code_n"], cfg["rounds"], traffic["p"])
        self.plan = build_sliding_window_plan(
            self.dem.chk, self.dem.obs, self.dem.priors, n_half=cfg["code_n"] // 2, W=cfg["W"],
            F=cfg["F"], method=1, z_basis=True, code_n=cfg["code_n"])
        self.S = traffic["batch"]
        self.det, self.obs = sample_pool(self.dem, traffic["pool_batches"], self.S, seed, device)
        self.program = importlib.import_module(f"benchmark.programs.{cfg['decoder']}")
        self.factory = self.program.factory(cfg["knobs"], device)
        self.kept = []  # (batch index, sampled rows, their corrections, their verdicts)

    def batch(self, j: int, factory, keep: bool = False):
        """Decode and count batch ``j`` (the pool's batch ``j`` mod its size):
        its failures, and the pipeline's time of each window in seconds."""
        P = self.det.shape[0]
        det, obs = self.det[j % P], self.obs[j % P]
        out = self.decode_sliding_window(self.plan, det, factory, device=self.device,
                                         verbose=False, sync_per_window=True)
        ev = self.evaluate(self.plan, det, obs, out["total_e_hat"], device=self.device)
        if keep:
            rows = check_rows(self.seed, j, self.S, self.traffic["check_rows"])
            idx = torch.as_tensor(rows, device=self.device)
            self.kept.append((j, rows, out["total_e_hat"].index_select(0, idx),
                              np.asarray(ev["failed"])[rows]))
        return ev["num_failed"], out["window_seconds"]

    def window(self, seconds: float, run: Run):
        j = 1
        t_open = time.perf_counter()
        while True:
            failures, window_times_s = self.batch(j, self.factory, keep=True)
            run.failures += failures
            run.window_times_s += window_times_s
            run.shots += self.S
            j += 1
            if time.perf_counter() - t_open >= seconds:
                break
        run.window_s = time.perf_counter() - t_open

    def traced(self, run: Run):
        """The traced batches: profiled, staged, counted."""
        batches = list(range(1, 1 + self.traffic["trace_batches"]))
        run.batches = len(batches)
        state = {}
        # profiled pass: ranges only, no synchronisation beyond the pipeline's
        spans = tr.Spans("profiled", self.cuda)
        fac = Instrumented(self.factory, spans, state)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with tr.Patches() as pt:
            self._install_stages(pt, spans, state)
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(TRACE_WINDOW):
                    for j in batches:
                        with spans.span("batch"):
                            run.failures += self.batch(j, fac, keep=True)[0]
                            fac.close_window()
                        run.shots += self.S
                    if self.cuda:
                        torch.cuda.synchronize()
        run.profile = read_profile(prof, spans.names, TRACE_WINDOW)
        del prof
        # staged pass: synchronised spans
        spans = tr.Spans("staged", self.cuda)
        fac = Instrumented(self.factory, spans, state)
        with tr.Patches() as pt:
            self._install_stages(pt, spans, state)
            for j in batches:
                with spans.span("batch"):
                    self.batch(j, fac)
        run.spans = dict(spans.totals)
        # counted pass: the fused BP calls' work and the shots OSD decoded
        counter = tr.WorkCounter(self.device)
        fac = Instrumented(self.factory, tr.Spans("off", False), state, counter)
        with tr.Patches() as pt:
            for mod, attr in tr.port_bp_run():
                pt.set(mod, attr, counter.wrap_bp_run(getattr(mod, attr)))
            for j in batches:
                self.batch(j, fac)
        run.counts = {"bp_bound_s": float(counter.bound_s), "osd_shots": int(counter.osd_shots)}

    def _install_stages(self, pt, spans, state):
        for target, attr, name_of in self.program.stages(state):
            owner = tr.resolve(target)
            pt.set(owner, attr, spans.wrap(name_of, getattr(owner, attr)))

    def release(self):
        """Drop the program's state (decoders, tables) before the reference."""
        self.factory = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def check(cell: dict, prog: Cell, seed: int) -> dict:
    """The sampled shots of up to ``check_batches`` kept batches, drawn from
    the seed, decoded again by the reference: the share that differs."""
    from .reference.pipeline import Reference

    traffic = cell["traffic"]
    rng = np.random.default_rng([seed, 7])
    kept = prog.kept
    pick = sorted(rng.choice(len(kept), size=min(traffic["check_batches"], len(kept)),
                             replace=False))
    ref = Reference(cell["config"], prog.dem, prog.device)
    P = prog.det.shape[0]
    differing = total = 0
    if traffic["check_rows"] >= prog.S:  # whole batches, one at a time
        groups = [[kept[i]] for i in pick]
    else:
        groups = [[kept[i] for i in pick]]
    for group in groups:
        det = torch.cat([prog.det[j % P][torch.as_tensor(r, device=prog.device)]
                         for j, r, _, _ in group])
        obs = torch.cat([prog.obs[j % P][torch.as_tensor(r, device=prog.device)]
                         for j, r, _, _ in group])
        ref_total, ref_failed = ref.decode(det, obs)
        mine = torch.cat([t for _, _, t, _ in group])
        verdicts = np.concatenate([f for _, _, _, f in group])
        diff = (mine != ref_total).any(dim=1).cpu().numpy() | (verdicts != ref_failed.cpu()
                                                                .numpy())
        differing += int(diff.sum())
        total += diff.size
    share = 100.0 * differing / max(total, 1)
    return {"differing_shots_pct": share, "differing_shots": differing, "checked_shots": total}


def judge(cell: dict, prog: Cell, seed: int) -> dict:
    """``check`` held to the cell's limit."""
    verdict = check(cell, prog, seed)
    limit = cell["limits"]["differing_shots_pct"]
    return {"correct": verdict["differing_shots_pct"] <= limit,
            "checked_shots": verdict["checked_shots"],
            "check": {"differing_shots_pct": {"value": verdict["differing_shots_pct"],
                                              "limit": limit}}}


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
             device: torch.device) -> dict:
    cuda = device.type == "cuda"
    prog = Cell(cell, seed, device)
    if cuda:
        from slidingwindowdecoder_torch.utils import cuda_build

        cuda_build.build(sorted(p.name for p in cuda_build.CSRC.glob("*.cu")))
    prog.batch(0, prog.factory)  # warm-up: the cell's own shapes
    if cuda:
        torch.cuda.synchronize()
    run = Run(setup_s=time.perf_counter() - t_start)
    if trace:
        prog.traced(run)
    else:
        prog.window(seconds, run)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {bad}")
    prog.release()
    verdict = judge(cell, prog, seed)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = read_metric(m["name"], run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace and run.profile:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
    result = {"correct": verdict["correct"], "attempted": run.shots,
              "failed": 0, "metrics": metrics, "device": dev,
              "logical_failures": run.failures,
              "ler_wilson95": list(wilson_interval(run.failures, run.shots)),
              "checked_shots": verdict["checked_shots"]}
    if trace and run.profile:
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["check"] = verdict["check"]
    return result
