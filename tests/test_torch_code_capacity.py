"""The port's code-capacity drivers against the JAX package (CPU).

``harness.code_capacity.data_qubit_noise_decoding`` samples with numpy as
the JAX driver does, so both decode the same shots: with the port's
``BPGD`` and ``BPOSD`` (OSD-0 and OSD-CS) on one side and the JAX
decoders on the other, the counts must be equal. The decoders run the
code-capacity knobs (min-sum 0.625, ``gd_factor`` 0.8, no pre-BP for BPGD)
on jittered priors, so the JAX CN stage runs as the Pallas kernel in
interpret mode (XLA cannot contract it into an FMA,
tests/test_bp_pallas.py:108-115), at 128 shots a batch (its lane width).

``harness.device_campaign`` samples with torch on the decoder's device, so
it is held to its contract instead: a batch's errors depend on (seed,
process_id, batch_index) only, padded shots are not counted, the float32
mod-2 product is exact, and a stopped and resumed checkpointed run counts
what an uninterrupted run counts.
"""

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.codes import bb_code_by_n
from slidingwindowdecoder_torch.decoders import BPGD, BPOSD
from slidingwindowdecoder_torch.harness import code_capacity as tcc
from slidingwindowdecoder_torch.harness import device_campaign as tdc
from slidingwindowdecoder_torch.parallel.checkpoint import MonteCarloCheckpoint
from slidingwindowdecoder_tpu.decoders import BPGD as JBPGD
from slidingwindowdecoder_tpu.decoders import BPOSD as JBPOSD
from slidingwindowdecoder_tpu.harness import code_capacity as jcc


@pytest.fixture(scope="module")
def bb72():
    code, _, _ = bb_code_by_n(72)
    return code


@pytest.fixture(autouse=True)
def one_thread():
    """The inputs are small, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _decoders(code, probs, bpgd, bposd, **extra):
    osd = dict(max_iter=30, ms_scaling_factor=0.625, **extra)
    return {
        "bpgd": bpgd(code.hx, probs, max_iter=0, max_iter_per_step=12, gd_factor=0.8,
                     max_step=code.N, new_n=code.N, row_bucket=128, **extra),
        "osd0": bposd(code.hx, probs, osd_method="osd_0", **osd),
        "osdcs": bposd(code.hx, probs, osd_method="osd_cs", osd_order=6, **osd),
    }


def test_data_qubit_noise_decoding_matches_jax(bb72):
    """256 shots at p=0.1 in two batches, seed 11: the same failures and
    flags per decoder as the JAX driver with the JAX decoders."""
    rng = np.random.default_rng(2)
    probs = 0.1 * (0.75 + 0.5 * rng.random(bb72.N))
    kw = dict(batch_size=128, seed=11, verbose=False)
    rt = tcc.data_qubit_noise_decoding(
        bb72, 0.1, 256, _decoders(bb72, probs, BPGD, BPOSD, device="cpu"), **kw)
    rj = jcc.data_qubit_noise_decoding(
        bb72, 0.1, 256, _decoders(bb72, probs, JBPGD, JBPOSD, cn_engine="pallas_interpret"),
        **kw)
    for name in rj:
        assert (rt[name]["num_err"], rt[name]["num_flagged"], rt[name]["shots"]) == (
            rj[name]["num_err"], rj[name]["num_flagged"], rj[name]["shots"]), name
    assert rj["osd0"]["num_flagged"] > 0 and rj["osd0"]["num_err"] > 0
    assert rj["bpgd"]["num_err"] > 0


class _Recorder:
    """A decoder stub: records the syndromes, returns no correction."""

    device = torch.device("cpu")

    def __init__(self):
        self.seen = []

    def core(self, synds):
        self.seen.append(synds.clone())
        B = synds.shape[0]
        return {"error": torch.zeros((B, 72), dtype=torch.uint8),
                "converged": torch.zeros(B, dtype=torch.bool)}


def test_batch_errors_depend_on_seed_process_and_index(bb72):
    rec = _Recorder()
    step = tdc.make_cc_step(bb72, 0.05, rec, 32, seed=3)
    other = tdc.make_cc_step(bb72, 0.05, rec, 32, seed=3, process_id=1)
    for args in ((0, 32), (1, 32), (0, 32)):
        step(*args)
    other(0, 32)
    s = rec.seen
    assert torch.equal(s[0], s[2])
    assert not torch.equal(s[0], s[1]) and not torch.equal(s[0], s[3])
    assert s[0].dtype == torch.uint8 and s[0].shape == (32, bb72.hx.shape[0])


def test_valid_count_leaves_padded_shots_out(bb72):
    """With no correction every error is its own residual: the counts are
    the shots with a logical error (and all flagged) among the first
    ``valid_count``."""
    rec = _Recorder()
    step = tdc.make_cc_step(bb72, 0.08, rec, 64, seed=5)
    failed, flagged = step(7, 40)
    synd = rec.seen[-1].numpy()
    # the errors again, from the same generator seed
    gen = torch.Generator().manual_seed(tdc.batch_seed(5, 0, 7))
    err = (torch.rand((64, bb72.N), generator=gen) < 0.08).numpy().astype(np.int64)
    np.testing.assert_array_equal(synd, (err @ bb72.hx.T) % 2)
    logical = ((err @ bb72.hz_perp.T) % 2).any(axis=1)
    assert (failed, flagged) == (int(logical[:40].sum()), 40)
    assert int(logical.sum()) > failed > 0


def test_mod2_matmul_is_exact_past_256():
    """Row sums of the product pass 256 (a bfloat16 result would round
    them); the float32 product mod 2 equals numpy's integer one."""
    rng = np.random.default_rng(0)
    x = rng.random((16, 700)) < 0.9
    w = (rng.random((700, 12)) < 0.8).astype(np.float32)
    assert (x.astype(np.int64) @ w.astype(np.int64)).max() > 256
    out = tdc._mod2_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), (x.astype(np.int64) @ w.astype(np.int64)) % 2)


class _Stop(Exception):
    pass


def test_checkpointed_campaign_resumes(bb72, tmp_path):
    """A run stopped after its third batch (a checkpoint after every
    batch) and resumed counts exactly what an uninterrupted run counts;
    resuming under another seed is refused."""
    dec = BPOSD(bb72.hx, np.full(bb72.N, 0.06), max_iter=20, osd_method="osd_0",
                device="cpu")
    kw = dict(batch=64, seed=21, checkpoint_every=1, warmup=False)
    whole = tdc.run_cc_campaign_device(bb72, 0.06, 5 * 64 - 10, dec, **kw)
    assert whole["shots"] == 310 and whole["num_err"] > 0

    ck = MonteCarloCheckpoint(str(tmp_path))
    core, calls = dec.core, []

    def stopping(synds):
        calls.append(1)
        if len(calls) > 3:
            raise _Stop
        return core(synds)

    dec.core = stopping
    with pytest.raises(_Stop):
        tdc.run_cc_campaign_device(bb72, 0.06, 310, dec, checkpoint=ck, **kw)
    assert ck.load()["batch_index"] == 3
    dec.core = core
    resumed = tdc.run_cc_campaign_device(bb72, 0.06, 310, dec, checkpoint=ck, **kw)
    for k in ("num_err", "num_flagged", "shots"):
        assert resumed[k] == whole[k], k
    with pytest.raises(ValueError, match="root_seed"):
        tdc.run_cc_campaign_device(bb72, 0.06, 310, dec, checkpoint=ck,
                                   **dict(kw, seed=22))
