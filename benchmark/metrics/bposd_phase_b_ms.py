"""Per batch, the synchronised time of the phase-B bucket calls
of ``BPOSD._run_bp``."""


def read(run):
    if not run.batches or "bposd.phase_b" not in run.spans:
        return None
    return run.spans["bposd.phase_b"] / run.batches * 1e3
