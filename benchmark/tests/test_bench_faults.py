"""The check fails a run whose timed path is broken underneath: a BP step
that returns its state unchanged, half of each batch left out, an answer
altered where it is produced. (One card, so no exchange between cards.)"""

import pytest
import torch

from tiny import run_tiny

BP_MODULE = {"bposd-p004": "slidingwindowdecoder_torch.decoders.bposd",
             "gdg-p005": "slidingwindowdecoder_torch.decoders.gdg"}


def _core_patch(monkeypatch, edit):
    """Wrap every decoder's ``core`` on the window path with ``edit``."""
    from slidingwindowdecoder_torch.windows import pipeline

    real = pipeline.CachingDecoderFactory.__call__

    def call(self, spec):
        dec = real(self, spec)

        class Broken:
            def core(self, synd):
                return edit(dec.core, synd)

        return Broken()

    monkeypatch.setattr(pipeline.CachingDecoderFactory, "__call__", call)


def _unchanged_state(monkeypatch, workload):
    import importlib

    mod = importlib.import_module(BP_MODULE[workload])

    def bp_run(garr, mv, prior, syndrome, history, error, done, iters, **k):
        out = (mv, history, error, done, iters)
        return out + (syndrome if k.get("state_layout") == "transposed" else syndrome.T,) \
            if k.get("return_synd") else out

    monkeypatch.setattr(mod, "bp_run", bp_run)


def _half_batch(monkeypatch, workload):
    def edit(core, synd):
        half = synd.shape[0] // 2
        out = core(synd[:half])
        err = torch.zeros((synd.shape[0], out["error"].shape[1]), dtype=out["error"].dtype)
        err[:half] = out["error"]
        conv = torch.zeros(synd.shape[0], dtype=torch.bool)
        conv[:half] = out["converged"]
        return {"error": err, "converged": conv}

    _core_patch(monkeypatch, edit)


def _altered_answer(monkeypatch, workload):
    def edit(core, synd):
        out = dict(core(synd))
        err = out["error"].clone()
        err[:, 0] ^= 1
        out["error"] = err
        return out

    _core_patch(monkeypatch, edit)


@pytest.mark.parametrize("workload", ["bposd-p004", "gdg-p005"])
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_answer],
                         ids=["unchanged_state", "half_batch", "altered_answer"])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch, workload)
    r = run_tiny(workload)
    assert r["correct"] is False
    c = r["check"]["differing_shots_pct"]
    assert c["value"] > c["limit"]
