"""The yardstick of the fused BP kernel: the H100's peaks and the bound of
one ``bp_run`` call on its inputs.

A frozen copy of ``slidingwindowdecoder_torch/utils/roofline.py``
(``H100``, ``SPAN_OPS_PER_EDGE``, ``SPAN_OPS_PER_VN``, ``span_bound``) at
commit 6c64bcc, with the bytes counted over valid edges and real checks
where the original counts the padded ``m_pad`` slots (a property of the
layout, not of the work): per column not done at entry, its messages read
and written once (``2 * edges`` of the message dtype), its int32 syndrome
and sign seed (``8 * m``), its error written (``n``) and, masked, its VN
state read (``n``); plus every history-ring write. The operations are
``SPAN_OPS_PER_EDGE`` a valid edge and ``SPAN_OPS_PER_VN`` a VN for every
shot-iteration run, at the float32 rate. The bound is the larger of the
two times.
"""

from __future__ import annotations

import torch

# the H100 SXM5 80GB HBM3's public specs: 3.35 TB/s; 132 SMs x 1.98 GHz x
# 128 float32 results a clock an SM
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 132 * 128 * 1.98e9
SPAN_OPS_PER_EDGE, SPAN_OPS_PER_VN = 25, 3


def span_bound_s(*, live, shot_iters, hist_writes, edges: int, n: int, m: int,
                 msg_bytes: int, ring_bytes: int, masked: bool):
    """The bound in seconds: float64 tensors in and out, or numbers."""
    ops = shot_iters * (edges * SPAN_OPS_PER_EDGE + n * SPAN_OPS_PER_VN)
    per_col = 2 * edges * msg_bytes + 8 * m + (2 if masked else 1) * n
    nbytes = live * per_col + ring_bytes * hist_writes
    ops_s = ops / FP32_OPS_PER_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    if isinstance(ops_s, torch.Tensor):
        return torch.maximum(ops_s, bytes_s)
    return max(ops_s, bytes_s)
