"""The program side of the ``bposd`` configurations: the port's per-window
BP+OSD factory and the calls the traced run wraps in spans."""

from __future__ import annotations

MODULE = "slidingwindowdecoder_torch.decoders.bposd"


def factory(knobs: dict, device):
    from slidingwindowdecoder_torch.harness.circuit_level import window_decoder_factory

    return window_decoder_factory(False, device=device, **knobs)


def stages(state: dict):
    """(module, attribute, span name of a call) of the decoder's stages.
    ``BPOSD._run_bp``'s first call in a ``core`` call is phase A (the whole
    batch), the others phase-B buckets; ``state["core_calls"]`` counts the
    ``_run_bp`` calls since ``core`` was entered (the harness resets it)."""

    def run_bp_name(*a, **k):
        state["core_calls"] = state.get("core_calls", 0) + 1
        return "bposd.phase_a" if state["core_calls"] == 1 else "bposd.phase_b"

    return [
        (f"{MODULE}:BPOSD", "_run_bp", run_bp_name),
        (MODULE, "osd_decode", lambda *a, **k: "bposd.osd"),
    ]
