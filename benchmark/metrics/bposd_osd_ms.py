"""Per batch, the synchronised time of the ``osd_decode`` calls."""


def read(run):
    if not run.batches or "bposd.osd" not in run.spans:
        return None
    return run.spans["bposd.osd"] / run.batches * 1e3
