"""The sliding-window GDG case of the port against the JAX package, shared
by ``test_torch_gdg_sw.py`` (GDG alone) and ``test_torch_gdg_sw_osd.py``
(with ``last_win_osd``): not a test module itself.

Each case is a file of its own, so that ``--dist loadfile`` runs the two
on different workers: each case's CPU decode (~85 s on two torch threads,
one worker alone) and the JAX run (~65 s) were the longest file of the
suite together.
"""

import contextlib

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.circuits import sample_dem_numpy
from slidingwindowdecoder_torch.harness import circuit_level as tcl
from slidingwindowdecoder_tpu.harness import circuit_level as jcl

SW = dict(N=72, p=0.01, num_repeat=3, num_shots=128, W=2, F=1, max_iter=8, seed=2024,
          verbose=False)


@contextlib.contextmanager
def torch_threads(k):
    """At most ``k`` torch intra-op threads inside the block: where the
    test workers share the cores, a decode of many small ops spends its
    time in threads waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(k, n))
    try:
        yield
    finally:
        torch.set_num_threads(n)


def weight(llr, e):
    return float(np.asarray(e, np.float64) @ llr.astype(np.float64))


def jax_sw():
    """The JAX ``sliding_window_gdg`` with ``last_win_osd`` on the [[72]]
    smoke experiment (its GDG counts are those without), with the GDG
    corrections of its timed decode, read from its window pipeline's
    result (the driver returns only the OSD-redone ones)."""
    seen, pipeline = [], jcl.decode_sliding_window

    def keep_total(*a, **k):
        out = pipeline(*a, **k)
        seen.append(np.asarray(out["total_e_hat"]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcl, "decode_sliding_window", keep_total)
        res = jcl.sliding_window_gdg(ensemble_mode="host_loop", last_win_osd=True, **SW)
    _, _, dem, plan = jcl.build_bb_window_experiment(72, 0.01, 3, 2, 1)
    det, _, _ = sample_dem_numpy(dem, SW["num_shots"], np.random.default_rng(SW["seed"]))
    return res, seen[-1], plan, det


def check_sliding_window_gdg(jax_result, last_win_osd):
    """[[72]] x3 rounds, W=2, p=0.01, 128 shots from seed 2024, pre-BP 8:
    the GDG corrections, failures and flags equal JAX's; with
    ``last_win_osd`` the BPOSD re-decode of the last window too, where a
    shot may differ only at an exact OSD-CS tie (ROADMAP section 3)."""
    rj, total_j, plan, det = jax_result
    # 32-shot ensemble buckets (JAX: its default 64): the results do not
    # depend on the bucket, and the CPU decode takes half the time
    with torch_threads(2):
        rt = tcl.sliding_window_gdg(device="cpu", last_win_osd=last_win_osd,
                                    ensemble_bucket=32, **SW)
    np.testing.assert_array_equal(rt["total_e_hat"].numpy(), total_j)
    for k in ("num_failed", "num_flagged", "num_windows", "ler"):
        assert rt[k] == rj[k], k
    assert rt["num_failed"] > 0
    if not last_win_osd:
        assert "last_win_osd" not in rt
        return
    assert rt["last_win_osd"] == rj["last_win_osd"]
    spec = plan.windows[-1]
    tt, tj = rt["total_e_hat_osd"].numpy(), np.asarray(rj["total_e_hat_osd"])
    np.testing.assert_array_equal(tt[:, :spec.col_start], tj[:, :spec.col_start])
    cols = slice(spec.col_start, spec.col_end)
    prefix = total_j.copy()
    prefix[:, spec.col_start:] = 0
    synd = (det ^ (prefix.astype(np.int64) @ plan.chk.T % 2))[:, spec.row_start:spec.row_end]
    llr = np.log((1 - spec.prior) / spec.prior)
    differ = np.nonzero((tt != tj).any(axis=1))[0]
    assert len(differ) <= 2
    for i in differ:
        for e in (tt[i, cols], tj[i, cols]):
            np.testing.assert_array_equal((e.astype(np.int64) @ spec.mat.T) % 2, synd[i])
        assert weight(llr, tt[i, cols]) == pytest.approx(weight(llr, tj[i, cols]), rel=1e-12)
