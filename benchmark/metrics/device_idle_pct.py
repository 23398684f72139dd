"""The share of the profiled pass in which nothing runs on the device."""


def read(run):
    p = run.profile
    if not p.get("window_s"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
