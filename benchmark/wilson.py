"""The Wilson score interval of a binomial rate: a frozen copy of
``slidingwindowdecoder_torch/utils/metrics.py:wilson_interval`` at commit
6c64bcc. A run reports its logical error rate with it, beside the
metrics."""

import math


def wilson_interval(errors: int, shots: int, z: float = 1.96):
    if shots == 0:
        return (0.0, 1.0)
    p = errors / shots
    denom = 1 + z * z / shots
    center = (p + z * z / (2 * shots)) / denom
    half = z * math.sqrt(p * (1 - p) / shots + z * z / (4 * shots * shots)) / denom
    return (max(0.0, center - half), min(1.0, center + half))
