"""Kernel launches per batch in the profiled pass."""


def read(run):
    if not run.batches or not run.profile.get("kernel_launches"):
        return None
    return run.profile["kernel_launches"] / run.batches
