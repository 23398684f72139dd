"""Per batch, the synchronised time of ``_select_and_decimate_t``
(the select and its decide-and-peel)."""


def read(run):
    if not run.batches or "gdg.select" not in run.spans:
        return None
    return run.spans["gdg.select"] / run.batches * 1e3
