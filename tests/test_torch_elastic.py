"""The port's elastic recovery (``parallel/elastic.py`` on its
``parallel/checkpoint.py``) against the JAX package's on the scenario of
``tests/test_parallel.py::test_elastic_recovery`` (3 hosts, host 0
completes, host 1 dies after 3 batches, host 2 never starts), each side
in its own checkpoint directory: the same plans, lost hosts, replayed
counts and merged counts; then a recovery through the port's decoders."""

import os
import time

import numpy as np
import pytest
import torch

from slidingwindowdecoder_torch.parallel import checkpoint as tck
from slidingwindowdecoder_torch.parallel import elastic as tel
from slidingwindowdecoder_tpu.parallel import checkpoint as jck
from slidingwindowdecoder_tpu.parallel import elastic as jel
from slidingwindowdecoder_tpu.parallel.distributed import host_shot_range

TOTAL, BATCH, HOSTS, SEED = 120, 10, 3, 17


def _crash_run(ck, directory, pid, crash_at, draw):
    """Host ``pid``'s campaign, dying after ``crash_at`` batches."""
    _, count = host_shot_range(TOTAL, pid, HOSTS)
    calls = {"n": 0}

    def f(idx, shots, *rng):
        calls["n"] += 1
        if crash_at is not None and calls["n"] > crash_at:
            raise RuntimeError("host died")
        return draw(pid, idx, *rng)

    try:
        ck.run_checkpointed(count, BATCH, f, ck.MonteCarloCheckpoint(str(directory), pid),
                            checkpoint_every=1, root_seed=SEED)
    except RuntimeError:
        pass


def _jax_draw(pid, idx, rng):
    return {"failed": int(rng.integers(0, 3))}


def _torch_draw(pid, idx):
    return {"failed": int(tck.batch_rng(SEED, pid, idx).integers(0, 3))}


def _view(plan):
    return {pid: (r.batches_done, r.num_batches, r.counts, r.complete,
                  r.stale_seconds is None, r.lost) for pid, r in plan.items()}


def test_elastic_recovery_matches_jax(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    for pid, crash_at in ((0, None), (1, 3)):
        _crash_run(jck, jdir, pid, crash_at, _jax_draw)
        _crash_run(tck, tdir, pid, crash_at, _torch_draw)

    plans = [(mod.plan_recovery(str(d), TOTAL, BATCH, HOSTS)) for mod, d in
             ((jel, jdir), (tel, tdir))]
    assert _view(plans[0]) == _view(plans[1])
    assert plans[1][1].batches_done == 3 and plans[1][2].stale_seconds is None
    assert tel.lost_hosts(plans[1], 1e9) == jel.lost_hosts(plans[0], 1e9) == [2]
    assert list(plans[1][1].remaining_batches) == list(plans[0][1].remaining_batches)

    # host 1's heartbeat goes stale on both sides
    old = time.time() - 3600
    for ck, d in ((jck, jdir), (tck, tdir)):
        path = ck.MonteCarloCheckpoint(str(d), 1)._file
        os.utime(path, (old, old))
    stale = [mod.plan_recovery(str(d), TOTAL, BATCH, HOSTS, stale_after=600)
             for mod, d in ((jel, jdir), (tel, tdir))]
    assert _view(stale[0]) == _view(stale[1])
    assert sorted(tel.lost_hosts(stale[1], 600)) == [1, 2]

    merged_j = jel.resume_lost_hosts(str(jdir), TOTAL, BATCH, HOSTS,
                                     lambda pid: lambda i, s, rng: _jax_draw(pid, i, rng),
                                     stale_after=600, root_seed=SEED, checkpoint_every=1)
    merged_t = tel.resume_lost_hosts(str(tdir), TOTAL, BATCH, HOSTS,
                                     lambda pid: lambda i, s: _torch_draw(pid, i),
                                     stale_after=600, root_seed=SEED, checkpoint_every=1)
    assert merged_t == merged_j
    assert tel.merge_counts(tel.plan_recovery(str(tdir), TOTAL, BATCH, HOSTS)) == merged_t


def test_recovery_through_the_ports_decoder(tmp_path):
    """A 3-host [[72]] code-capacity BP+OSD-0 campaign on the CPU: host 1
    dies after 2 batches, host 2 never starts; the recovery replays their
    remaining batches, and the merged counts equal an uninterrupted
    campaign's."""
    from slidingwindowdecoder_torch.codes import bb_code_by_n
    from slidingwindowdecoder_torch.decoders import BPOSD

    torch.set_num_threads(1)
    code, _, _ = bb_code_by_n(72)
    p, total, batch = 0.05, 96, 8
    dec = BPOSD(code.hx, np.full(code.N, p), max_iter=20, osd_method="osd_0", bp_bucket=8,
                osd_bucket=8, device="cpu")
    hz_perp_T = code.hz_perp.T.astype(np.int64)

    def factory(pid, crash_at=None):
        calls = {"n": 0}

        def run_batch(idx, shots):
            calls["n"] += 1
            if crash_at is not None and calls["n"] > crash_at:
                raise RuntimeError("host died")
            rng = tck.batch_rng(SEED, pid, idx)
            errs = (rng.random((shots, code.N)) < p).astype(np.uint8)
            res = dec.decode_batch((errs @ code.hx.T) % 2)
            logical = (((res.error ^ errs) @ hz_perp_T) % 2).any(axis=1)
            return {"failed": int(logical.sum()), "shots": shots}
        return run_batch

    for pid, crash_at in ((0, None), (1, 2)):
        _, count = host_shot_range(total, pid, HOSTS)
        try:
            tck.run_checkpointed(count, batch, factory(pid, crash_at),
                                 tck.MonteCarloCheckpoint(str(tmp_path), pid),
                                 checkpoint_every=1, root_seed=SEED)
        except RuntimeError:
            pass
    merged = tel.resume_lost_hosts(str(tmp_path), total, batch, HOSTS, factory,
                                   stale_after=-1.0, root_seed=SEED, checkpoint_every=1)
    ref = {"failed": 0, "shots": 0}
    for pid in range(HOSTS):
        _, count = host_shot_range(total, pid, HOSTS)
        out = tck.run_checkpointed(count, batch, factory(pid),
                                   tck.MonteCarloCheckpoint(str(tmp_path / "ref"), pid),
                                   checkpoint_every=1, root_seed=SEED)
        for k, v in out["counts"].items():
            ref[k] += v
    assert merged == ref and merged["shots"] == total
    # a host alive mid-range (a fresh heartbeat) is not replayed: recovery raises
    ckpt0 = tck.MonteCarloCheckpoint(str(tmp_path), 0)
    ckpt0.save({**ckpt0.load(), "batch_index": 1})
    with pytest.raises(RuntimeError, match="still incomplete"):
        tel.resume_lost_hosts(str(tmp_path), total, batch, HOSTS, factory,
                              stale_after=1e9, root_seed=SEED)
