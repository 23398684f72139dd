"""The phenomenological-noise driver of the port against the JAX package,
on the CPU.

``decode_phenomenological`` decodes the noisy syndrome with ``[hx | I]``
and priors ``[p]*N + [p_synd]*m``; both packages draw the same samples
from a seed. Each decoder is wrapped to record the corrections it returns,
so one run of each package gives its per-shot corrections and its count.

With BP+OSD-CS (the phenom-osd row's decoder: min-sum 0.625, OSD-CS-10) on
[[72]] ([hx | I] 36x108) at p = 0.04, p_synd = 0.01, 384 shots in batches
of 128 (the JAX CN stage runs as the Pallas kernel in interpret mode, at
its 128-shot lane width: at a min-sum factor below 1 XLA's own CN stage
contracts into an FMA, tests/test_bp_pallas.py:108-115): the same
failure count, and the same correction on every shot but where two OSD-CS
candidates have exactly equal f64 path metrics (two distinct priors make
such ties likely, and each side's f32 sums may round either one lower,
ROADMAP §3): both corrections then satisfy the syndrome with equal f64
weight. The GDG form (the phenom-gdg row's knobs) runs only in a ``slow``
test (about 100 s): its ensemble's branches of equal weight tie in the
same way, and there a tie may move the count.
"""

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.codes import bb_code_by_n
from slidingwindowdecoder_torch.decoders import BPOSD, GDG
from slidingwindowdecoder_torch.harness.phenomenological import decode_phenomenological
from slidingwindowdecoder_tpu.decoders import BPOSD as JaxBPOSD
from slidingwindowdecoder_tpu.decoders import GDG as JaxGDG
from slidingwindowdecoder_tpu.harness.phenomenological import (
    decode_phenomenological as jax_decode_phenomenological,
)

P, P_SYND = 0.04, 0.01


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread: these decodes are many small ops, and where
    the test workers share the cores more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorder:
    """A decoder that keeps every batch of corrections it returns, and the
    syndromes, past the harness's warm-up call."""

    def __init__(self, dec):
        self.dec, self.errors, self.synds, self.calls = dec, [], [], 0

    def decode_batch(self, syndromes):
        res = self.dec.decode_batch(syndromes)
        if self.calls:
            self.errors.append(res.error)
            self.synds.append(np.asarray(syndromes))
        self.calls += 1
        return res


def _run(decode, build, code, shots, batch, seed):
    rec = {}

    def builder(pcm, pr):
        rec["dec"] = _Recorder(build(pcm, pr))
        rec["pcm"], rec["priors"] = pcm, pr
        return rec["dec"]

    res = decode(code, P, P_SYND, shots, {"d": builder}, batch_size=batch, seed=seed,
                 verbose=False)["d"]
    return res, np.concatenate(rec["dec"].errors), np.concatenate(rec["dec"].synds), rec


def _assert_same_but_ties(res_t, res_j, e_t, e_j, synd, rec, tied_counts=False):
    """Equal corrections but at exact f64 ties; equal failure counts, or
    with ``tied_counts`` counts apart by at most the tied shots (a tie's
    two corrections may differ by a logical operator)."""
    differ = np.nonzero((e_t != e_j).any(axis=1))[0]
    slack = len(differ) if tied_counts else 0
    assert abs(res_t["num_err"] - res_j["num_err"]) <= slack
    assert res_t["shots"] == res_j["shots"]
    pcm = rec["pcm"].astype(np.int64)
    llr = np.log((1 - rec["priors"]) / rec["priors"]).astype(np.float32).astype(np.float64)
    for b in differ:
        for e in (e_t, e_j):
            np.testing.assert_array_equal((pcm @ e[b]) % 2, synd[b], err_msg=f"shot {b}")
        assert llr @ e_t[b] == llr @ e_j[b], b
    return differ


def test_phenomenological_bposd_matches_jax():
    code = bb_code_by_n(72)[0]
    kw = dict(max_iter=100, ms_scaling_factor=0.625, osd_method="osd_cs", osd_order=10)
    res_t, e_t, synd, rec = _run(decode_phenomenological,
                                 lambda pcm, pr: BPOSD(pcm, pr, device="cpu", **kw),
                                 code, 384, 128, 17)
    res_j, e_j, synd_j, _ = _run(
        jax_decode_phenomenological,
        lambda pcm, pr: JaxBPOSD(pcm, pr, cn_engine="pallas_interpret", **kw),
        code, 384, 128, 17)
    np.testing.assert_array_equal(synd, synd_j)
    assert rec["pcm"].shape == (36, 108)
    _assert_same_but_ties(res_t, res_j, e_t, e_j, synd, rec)
    assert res_t["num_err"] > 0


@pytest.mark.slow
def test_phenomenological_gdg_matches_jax():
    """The phenom-gdg row's GDG knobs (tools/validate_parity.py:245-258:
    multi-thread, low-error mode, 256-shot ensemble buckets) on [[72]], 256
    shots: the JAX corrections but at exact ties (seed 17: one shot, whose
    two corrections of equal weight differ by a logical operator, so the
    counts are 25 and 24), and the JAX count but for such shots. The JAX
    side runs host-stepped with its CN stage in interpret-mode Pallas (its
    fused ensemble takes minutes to compile on the CPU)."""
    code = bb_code_by_n(72)[0]
    kw = dict(max_iter=8, ms_scaling_factor=0.625, gdg_factor=0.625, max_iter_per_step=6,
              max_step=40, max_tree_depth=4, max_side_depth=20, max_side_branch_step=30,
              max_tree_branch_step=30, low_error_mode=True, ensemble_bucket=256)
    res_t, e_t, synd, rec = _run(decode_phenomenological,
                                 lambda pcm, pr: GDG(pcm, pr, device="cpu", **kw),
                                 code, 256, 256, 17)
    res_j, e_j, _, _ = _run(
        jax_decode_phenomenological,
        lambda pcm, pr: JaxGDG(pcm, pr, ensemble_mode="host_loop",
                               cn_engine="pallas_interpret", **kw),
        code, 256, 256, 17)
    _assert_same_but_ties(res_t, res_j, e_t, e_j, synd, rec, tied_counts=True)
