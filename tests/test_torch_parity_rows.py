"""The seven parity rows that ``tools/torch_validate_depolarizing.py`` runs
(and ``chip_smoke.py`` runs short forms of) carry the counts of
``docs/parity_results.jsonl``: the reference's failures and shots, and the
JAX package's seed-7 count at the JAX run's shots (its newest line for the
row)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import torch_validate_depolarizing as tool  # noqa: E402


def _jax_lines():
    rows = {}
    for line in (ROOT / "docs" / "parity_results.jsonl").read_text().splitlines():
        if line.strip():
            r = json.loads(line)
            rows[r["config"]] = r  # the newest line of a row wins
    return rows


@pytest.mark.parametrize("name", sorted(tool.ROWS))
def test_row_counts_match_the_jax_runs(name):
    kind, shots, (ref_fails, ref_shots), (jax_fails, jax_shots) = tool.ROWS[name]
    r = _jax_lines()[name]
    assert (ref_fails, ref_shots) == (r["ref_fails"], r["ref_shots"])
    assert (jax_fails, jax_shots) == (r["fails"], r["shots"])
    assert shots == r["shots"]
    assert kind == name.replace("-", "_").replace("_362", "")
