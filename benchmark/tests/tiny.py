"""Tiny cells for the CPU tests: a real cell of BENCHMARK.json cut to the
[[72,12,6]] code over 6 rounds and a few 64-shot batches."""

import copy
import time

import torch

from benchmark.harness import load_cell, run_cell


def tiny_cell(workload: str) -> dict:
    cell = copy.deepcopy(load_cell(workload))
    cell["config"].update(code_n=72, rounds=6)
    cell["traffic"].update(batch=64, pool_batches=2, trace_batches=1, check_batches=2,
                           check_rows=min(cell["traffic"]["check_rows"], 64))
    if cell["config"]["decoder"] == "gdg":
        cell["config"]["knobs"]["ensemble_bucket"] = 32
    return cell


def run_tiny(workload: str, trace: bool = False, seed: int = 2**31 + 11, cell=None):
    cell = cell or tiny_cell(workload)
    return run_cell(cell, seed, 0.5, trace, time.perf_counter(), torch.device("cpu"))
