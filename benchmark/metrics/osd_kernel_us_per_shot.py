"""Kernel B's device time (``gj_kernel`` and ``gj_cluster_kernel``) over the
shots that OSD decoded in the profiled batches."""


def read(run):
    t = sum(s for k, s in run.profile.get("kernel_s", {}).items() if "gj_" in k)
    shots = run.counts.get("osd_shots", 0)
    if not t or not shots:
        return None
    return t / shots * 1e6
