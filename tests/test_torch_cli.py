"""The port's command line (``harness/cli.py``) on the CPU: the JAX CLI's
subcommands and option strings plus ``--device``; ``sliding-window`` and
``phenomenological`` give the JAX ``main(argv)``'s JSON counts; the other
five give the counts of the port's own drivers called directly; the JSON
holds plain values only."""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.harness import cli as tcli
from slidingwindowdecoder_tpu.harness import cli as jcli
from slidingwindowdecoder_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]
COMMANDS = ("sliding-window", "gdg-window", "code-capacity", "global", "phenomenological",
            "depolarizing", "shyps")


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """Small inputs on one torch thread; no persistent JAX compilation
    cache for this worker's later tests."""
    monkeypatch.setattr(compile_cache, "enable", lambda *a, **k: None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class _Built(Exception):
    pass


def _options(main, monkeypatch):
    """{subcommand: its option strings} of ``main``'s parser."""
    seen = {}

    def capture(self, *a, **k):
        seen["ap"] = self
        raise _Built

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Built):
            main([])
    sub = next(a for a in seen["ap"]._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {s: (a.default, a.type) for a in p._actions for s in a.option_strings}
            for name, p in sub.choices.items()}


def test_option_strings_match_jax(monkeypatch):
    t, j = _options(tcli.main, monkeypatch), _options(jcli.main, monkeypatch)
    assert tuple(t) == tuple(j) == COMMANDS
    for name in COMMANDS:
        assert t[name].pop("--device") == ("cuda", str)
        assert t[name] == j[name], name


def _run(main, argv, tmp_path, name):
    path = tmp_path / f"{name}.json"
    assert main([*argv, "--quiet", "--json", str(path)]) == 0
    text = path.read_text()
    res = json.loads(text)

    def plain(v):
        if isinstance(v, dict):
            return all(isinstance(k, str) and plain(x) for k, x in v.items())
        if isinstance(v, list):
            return all(plain(x) for x in v)
        return v is None or isinstance(v, (bool, int, float, str))

    assert plain(res) and "tensor" not in text and "array" not in text
    return res


TIMING = {"sample_seconds", "decode_seconds", "shots_per_sec", "seconds"}


def _counts(res):
    if all(isinstance(v, dict) for v in res.values()):
        return {k: _counts(v) for k, v in res.items()}
    return {k: v for k, v in res.items() if k not in TIMING}


@pytest.mark.parametrize("argv", [
    ["sliding-window", "--N", "72", "--p", "0.01", "--rounds", "3", "-W", "2", "--shots", "64",
     "--seed", "2024", "--max-iter", "30", "--osd-order", "4"],
    ["phenomenological", "--N", "72", "--p", "0.07", "--p-synd", "0.01", "--shots", "128",
     "--batch", "64", "--seed", "7", "--osd-order", "4"],
])
def test_counts_match_the_jax_cli(argv, tmp_path):
    t = _run(tcli.main, [*argv, "--device", "cpu"], tmp_path, "torch")
    j = _run(jcli.main, argv, tmp_path, "jax")
    assert set(_flat_keys(t)) == set(_flat_keys(j))
    assert _counts(t) == _counts(j)
    assert sum(v for k, v in _flat_keys(t).items()
               if k.split(".")[-1] in ("num_failed", "num_err")) > 0


def _flat_keys(res, prefix=""):
    out = {}
    for k, v in res.items():
        if isinstance(v, dict):
            out.update(_flat_keys(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _direct(name):
    """The port's driver for each subcommand, called as the CLI calls it."""
    from slidingwindowdecoder_torch.codes import bb_code_by_n
    from slidingwindowdecoder_torch.decoders import BPGD
    from slidingwindowdecoder_torch.harness import circuit_level as tcl
    from slidingwindowdecoder_torch.harness.code_capacity import data_qubit_noise_decoding
    from slidingwindowdecoder_torch.harness.depolarizing import depolarizing_decoding
    from slidingwindowdecoder_torch.harness.shyps import decode_shyps

    code, _, _ = bb_code_by_n(72)
    if name == "gdg-window":
        res = tcl.sliding_window_gdg(N=72, p=0.01, num_repeat=3, num_shots=16, max_iter=8, W=2,
                                     F=1, seed=5, verbose=False, device="cpu")
        res.pop("total_e_hat")
        return res
    if name == "code-capacity":
        dec = BPGD(code.hx, np.full(code.N, 0.05), max_iter=24, ms_scaling_factor=0.625,
                   gd_factor=0.625, max_step=40, new_n=code.N, device="cpu")
        return data_qubit_noise_decoding(code, 0.05, 64, {"bpgd": dec}, batch_size=32, seed=5,
                                         verbose=False)
    if name == "global":
        return tcl.global_decoder(N=72, p=0.01, num_repeat=2, num_shots=32, max_iter=30,
                                  osd_order=4, seed=5, verbose=False, device="cpu")
    if name == "depolarizing":
        return depolarizing_decoding(code, 0.08, 32, max_iter=20, osd_order=4, batch_size=32,
                                     seed=5, verbose=False, device="cpu")
    res = decode_shyps(r=3, p=0.003, num_repeat=2, num_shots=32, seed=5, verbose=False,
                       device="cpu")
    res.pop("e_hat")
    return res


ARGV = {
    "gdg-window": ["--N", "72", "--p", "0.01", "--rounds", "3", "-W", "2", "--shots", "16",
                   "--max-iter", "8"],
    "code-capacity": ["--N", "72", "--p", "0.05", "--decoder", "bpgd", "--shots", "64",
                      "--batch", "32"],
    "global": ["--N", "72", "--p", "0.01", "--rounds", "2", "--shots", "32", "--max-iter", "30",
               "--osd-order", "4"],
    "depolarizing": ["--N", "72", "--p", "0.08", "--shots", "32", "--batch", "32",
                     "--max-iter", "20", "--osd-order", "4"],
    "shyps": ["--r", "3", "--p", "0.003", "--rounds", "2", "--shots", "32"],
}


@pytest.mark.parametrize("name", list(ARGV))
def test_counts_match_the_ports_drivers(name, tmp_path):
    t = _run(tcli.main, [name, *ARGV[name], "--seed", "5", "--device", "cpu"], tmp_path, name)
    d = json.loads(json.dumps(_direct(name)))
    assert set(_flat_keys(t)) == set(_flat_keys(d))
    assert _counts(t) == _counts(d)


def test_default_device_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["shyps", "--shots", "4", "--json", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_module_entry_point_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "slidingwindowdecoder_torch.harness.cli", "code-capacity",
         "--N", "72", "--p", "0.02", "--shots", "64", "--osd-order", "2", "--batch", "64",
         "--seed", "1", "--quiet", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**__import__("os").environ, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["bposd"]["shots"] == 64
