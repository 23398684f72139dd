"""Per batch, the synchronised time of the ensemble's masked
``bp_run`` bursts."""


def read(run):
    if not run.batches or "gdg.burst" not in run.spans:
        return None
    return run.spans["gdg.burst"] / run.batches * 1e3
