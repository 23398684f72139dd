"""BENCHMARK.json against the benchmark's contract, and what the
benchmark may import: nothing of JAX or of the JAX package anywhere, and
nothing of the port in the reference. Module names are compared by their
top-level name, the part before the first dot, as a whole: the port's
name begins with the JAX package's."""

import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX = {"jax", "jaxlib", "flax", "slidingwindowdecoder_tpu"}
PORT = "slidingwindowdecoder_torch"


def _metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in _metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"] + _metrics()]
    assert len(names) == len(set(names))
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for cell in cells:  # every cell reports set-up, one more end-to-end and a per-layer metric
        assert sum(cell in m["workloads"] for m in SPEC["per_layer"]) >= 1


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_imports(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & JAX
    if path.parent.name == "reference":
        assert PORT not in tops


def test_top_level_names_compare_whole():
    assert "slidingwindowdecoder_torch".split(".")[0] not in JAX
    assert "slidingwindowdecoder_tpu.ops".split(".")[0] in JAX
