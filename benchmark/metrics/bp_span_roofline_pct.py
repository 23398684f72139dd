"""The fused BP kernel's share of its roofline: the summed bound of the
profiled batches' ``bp_span`` calls (counted at the ``bp_run`` boundary,
``roofline.span_bound_s``) over the device time of every ``bp_span``
kernel in the profiled pass."""


def read(run):
    t = sum(s for k, s in run.profile.get("kernel_s", {}).items() if "bp_span" in k)
    if not t or not run.counts.get("bp_bound_s"):
        return None
    return 100.0 * run.counts["bp_bound_s"] / t
