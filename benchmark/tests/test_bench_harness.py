"""The harness end to end at a tiny size on the CPU, with the port's CPU
(plain) paths: every step of a run but the look for a card."""

import pytest

from tiny import run_tiny

CELLS = ["bposd-p004", "gdg-p005", "bposd-p003"]


@pytest.mark.parametrize("workload", CELLS)
def test_window_run_is_correct(workload):
    r = run_tiny(workload)
    assert r["correct"] is True
    assert r["attempted"] >= 64 and r["failed"] == 0
    assert set(r["metrics"]) == {"shots_per_s", "setup_s"}  # too few windows for a p95
    assert list(r)[-1] == "check"
    assert r["check"]["differing_shots_pct"]["value"] == 0.0


@pytest.mark.parametrize("workload", ["bposd-p004", "gdg-p005"])
def test_traced_run(workload):
    r = run_tiny(workload, trace=True)
    assert r["correct"] is True
    names = set(r["metrics"])
    assert "pipeline_self_ms" in names
    assert ("gdg_select_ms" in names) == (workload == "gdg-p005")
    assert ("bposd_osd_ms" in names) == (workload != "gdg-p005")
    assert not names & {"shots_per_s", "window_p95_ms", "setup_s"}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["window_s"] > 0
