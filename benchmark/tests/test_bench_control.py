"""The control of each configuration, put in the program's place, fails
its cells' check (the harness's own comparison and limit) at a test size
on the CPU: the flagship's reference with float8 e4m3 messages in place of
bfloat16, GDG's own bfloat16 path in place of float32. The program itself
passes the same check (``test_bench_harness.py``)."""

import pytest
import torch

from benchmark.control import control_reading
from tiny import tiny_cell


@pytest.mark.parametrize("workload", ["bposd-p004", "gdg-p005"])
def test_control_fails_the_check(workload):
    r = control_reading(tiny_cell(workload), 1, torch.device("cpu"))
    assert r["correct"] is False
    c = r["check"]["differing_shots_pct"]
    assert c["value"] > c["limit"]
