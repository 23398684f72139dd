"""Per batch, the window loop's time outside ``decoder.core``: the batch's
span (the window pipeline and the final accounting) less its ``core``
spans."""


def read(run):
    if not run.batches or "batch" not in run.spans:
        return None
    return (run.spans["batch"] - run.spans.get("core", 0.0)) / run.batches * 1e3
