"""The port's utilities against the JAX package on the CPU:
``utils/metrics.py`` (Wilson interval, LER per round, ``RunMetrics``),
``utils/roofline.py`` (the H100 model, counted by hand on a small graph)
and the native host library (``native.py`` on the port's copy of
``swd_native.cpp``)."""

import numpy as np
import pytest

from slidingwindowdecoder_torch import native as tnative
from slidingwindowdecoder_torch.graphs.tanner import compile_graph
from slidingwindowdecoder_torch.utils import metrics as tm
from slidingwindowdecoder_torch.utils import roofline as trl
from slidingwindowdecoder_tpu import native as jnative
from slidingwindowdecoder_tpu.utils import metrics as jm


@pytest.mark.parametrize("errors,shots", [(0, 0), (0, 100), (3, 100), (414, 16384),
                                          (100, 100), (7, 10_000_000)])
def test_wilson_and_ler_per_round_match_jax(errors, shots):
    assert tm.wilson_interval(errors, shots) == jm.wilson_interval(errors, shots)
    assert tm.wilson_interval(errors, shots, z=3.0) == jm.wilson_interval(errors, shots, z=3.0)
    if shots:
        assert tm.ler_per_round(errors / shots, 12) == jm.ler_per_round(errors / shots, 12)
    assert tm.rates_compatible(errors, shots, 2 * errors, 2 * shots) == \
        jm.rates_compatible(errors, shots, 2 * errors, 2 * shots)


def test_run_metrics_summary_matches_jax(tmp_path):
    outs = []
    for mod in (tm, jm):
        m = mod.RunMetrics(started=0.0)
        m.add(shots=100, failed=3)
        m.add(shots=28, failed=1, flagged=2)
        m.add_window_stats([0.5, 0.25, 1.0, 0.125], nonconverged=[3, 1, 0, 2])
        m.spans["decode"] = 1.5
        s = m.summary()
        for k in ("elapsed_seconds", "shots_per_sec"):  # wall clock since 0.0
            assert s.pop(k) > 0
        outs.append(s)
        with m.time_span("decode"):
            pass
        assert m.spans["decode"] >= 1.5
    assert outs[0] == outs[1]
    assert outs[0]["ler"] == 4 / 128 and outs[0]["window_worst_s"] == 1.0
    payload = tm.RunMetrics().write_json(str(tmp_path / "m" / "r.json"), extra={"N": 144})
    assert payload["N"] == 144 and (tmp_path / "m" / "r.json").exists()


def test_bp_iteration_model_counts_by_hand():
    """A 3x5 PCM: rows of weight 3, 2, 3 (8 edges, dc 3, m_pad 32 after the
    graph's row padding); per iteration and row 8 edges x 25 + 5 VNs x 3 =
    215 operations and 5 ring entries; per call a row's message block
    (dc x m_pad) read and written, its int32 syndrome and sign seed (8 B a
    padded check) and its VN state and error (2 B a VN)."""
    H = np.array([[1, 1, 0, 1, 0], [0, 1, 1, 0, 0], [1, 0, 1, 0, 1]], np.uint8)
    g = compile_graph(H)
    assert (g.num_edges, g.n, g.dc) == (8, 5, 3)
    model = trl.bp_iteration_model(g, 10, msg_bytes=2)
    assert model["flops"] == 10 * (8 * 25 + 5 * 3)
    assert model["bytes"] == 10 * 5 * 4
    assert model["call_bytes"] == 10 * (2 * 3 * g.m_pad * 2 + 8 * g.m_pad + 2 * 5)
    b = trl.span_bound(live=10, shot_iters=10 * 7, hist_writes=10 * 7 * 5, edges=8, n=5, dc=3,
                       m_pad=g.m_pad, msg_bytes=2, ring_bytes=4)
    assert b["ops"] == 7 * model["flops"]
    assert b["bytes"] == model["call_bytes"] + 7 * model["bytes"]
    assert b["bound_ms"] == max(b["ops_ms"], b["bytes_ms"])
    assert b["ops_ms"] == b["ops"] / (132 * 128 * 1.98e9) * 1e3
    assert b["bytes_ms"] == b["bytes"] / 3.35e12 * 1e3
    assert b["bound_by"] == ("operations" if b["ops_ms"] >= b["bytes_ms"] else "bytes")
    valid = np.ones((3, 32), bool)
    valid[2, 1] = False
    assert trl.cn_bound_bytes(valid, 3, 4, 2) == 2 * 95 * 4 * 2 + 3 * 4 * 4 + 3 * 3
    assert trl.gj_ops(3, 5, 1, 2, 4, 6) == ((3 * 1 + 5 + 3) + (2 * 1 + 5 + 3)) * 4 + 6 * 2


def test_roofline_needs_a_card(monkeypatch):
    import torch

    assert trl.detect_chip("cpu") == "cpu"
    g = compile_graph(np.eye(3, dtype=np.uint8))
    with pytest.raises(ValueError, match="CUDA device"):
        trl.measure_bp_roofline(None, g, None, torch.zeros((2, 3), dtype=torch.uint8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trl.detect_chip()


@pytest.fixture
def libraries():
    """Both native libraries, built on first use (decided here, not at
    import)."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("g++ unavailable")


@pytest.mark.usefixtures("libraries")
def test_native_rank_and_solve_match_jax(rng):
    for _ in range(12):
        m, n = int(rng.integers(2, 40)), int(rng.integers(2, 130))
        H = (rng.random((m, n)) < 0.3).astype(np.uint8)
        assert tnative.gf2_rank(H) == jnative.gf2_rank(H)
        order = rng.permutation(n).astype(np.int32)
        for synd in ((H @ (rng.random(n) < 0.2)) % 2, rng.integers(0, 2, m)):
            xt, rt = tnative.gf2_ordered_solve(H, order, synd)
            xj, rj = jnative.gf2_ordered_solve(H, order, synd)
            assert rt == rj
            if xj is None:
                assert xt is None
            else:
                np.testing.assert_array_equal(xt, xj)
                np.testing.assert_array_equal((H @ xt) % 2, synd)


@pytest.mark.usefixtures("libraries")
def test_native_serial_bp_matches_jax(rng):
    for _ in range(8):
        m = int(rng.integers(3, 12))
        n = int(rng.integers(m, 24))
        H = (rng.random((m, n)) < 0.35).astype(np.uint8)
        H[np.arange(m), rng.integers(0, n, m)] = 1
        prior = rng.normal(1.5, 1.0, n)
        synd = rng.integers(0, 2, m).astype(np.uint8)
        kw = dict(max_iter=int(rng.integers(1, 12)), alpha=0.8)
        t, j = tnative.serial_bp_decode(H, prior, synd, **kw), jnative.serial_bp_decode(
            H, prior, synd, **kw)
        assert (t["converged"], t["iterations"]) == (j["converged"], j["iterations"])
        np.testing.assert_array_equal(t["error"], j["error"])
        np.testing.assert_array_equal(t["posterior"], j["posterior"])


def test_native_library_missing(monkeypatch):
    """Without the library: the rank falls back to numpy, the rest raise
    (the JAX package's contract)."""
    monkeypatch.setattr(tnative, "load_library", lambda: None)
    H = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]], np.uint8)
    assert tnative.gf2_rank(H) == 2 and not tnative.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.gf2_ordered_solve(H, np.arange(3), np.zeros(3, np.uint8))
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.serial_bp_decode(H, np.ones(3), np.zeros(3, np.uint8))


def test_native_builds_into_build_dir():
    """The library is built into ``build/`` (listed in ``.gitignore``),
    never into the JAX package's ``native/``."""
    from slidingwindowdecoder_torch.utils.cuda_build import BUILD_DIR

    path = tnative.library_path()
    assert path.parent == BUILD_DIR and path.name.startswith("swd_native-")
