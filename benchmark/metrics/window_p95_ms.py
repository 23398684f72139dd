"""The 95th percentile of every window decode in the window."""

import statistics


def read(run):
    if len(run.window_times_s) < 20:
        return None
    return statistics.quantiles(run.window_times_s, n=100)[94] * 1e3
