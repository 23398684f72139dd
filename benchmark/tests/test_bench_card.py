"""A short run of each cell on the card (skips without one):
``python3 -m pytest benchmark/tests/test_bench_card.py`` on an H100."""

import time

import pytest

from benchmark.harness import load_cell, run_cell

CELLS = ["bposd-p004", "gdg-p005", "bposd-p003"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(card, workload):
    cell = load_cell(workload)
    cell["traffic"]["pool_batches"] = 4
    r = run_cell(cell, 2**31 + 3, 2.0, False, time.perf_counter(), card)
    assert r["correct"] is True
    assert r["device"]["kind"].startswith("NVIDIA")
    assert r["metrics"]["shots_per_s"]["value"] > 0
