"""The program side of the ``gdg`` configurations: the port's per-window
GDG factory and the calls the traced run wraps in spans."""

from __future__ import annotations

MODULE = "slidingwindowdecoder_torch.decoders.gdg"


def factory(knobs: dict, device):
    from slidingwindowdecoder_torch.harness.circuit_level import gdg_window_factory

    return gdg_window_factory(device=device, **knobs)


def stages(state: dict):
    """(module, attribute, span name of a call): the whole-batch pre-BP, the
    shortening, the ensemble's bursts (``gdg.bp_run`` is called by
    ``_ensemble_step`` only), its select with the aggressive
    decide-and-peel, and the guess's decide-and-peel."""
    return [
        (MODULE, "decode_bp", lambda *a, **k: "gdg.pre_bp"),
        (f"{MODULE}:GDG", "_shorten_state", lambda *a, **k: "gdg.shorten"),
        (MODULE, "bp_run", lambda *a, **k: "gdg.burst"),
        (MODULE, "_select_and_decimate_t", lambda *a, **k: "gdg.select"),
        (MODULE, "set_index_and_peel_t", lambda *a, **k: "gdg.guess_peel"),
    ]
