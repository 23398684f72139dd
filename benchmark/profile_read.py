"""What the profiled pass's trace says: device busy time, kernel time by
name and launch count, and the idle gaps of the device named by the
benchmark span the host was in.

Reads ``torch.profiler``'s events: device events (kernels, copies, sets)
and the host ranges of the benchmark's spans, on the profiler's one clock.
A range also appears on the device's timeline as an annotation under its
own name; those are left out of the device's work.
"""

from __future__ import annotations

from collections import defaultdict

from torch.autograd import DeviceType

TOP = 10


def _name(key: str) -> str:
    """A kernel's name without its arguments, return type and namespace."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0][:96]


def read_profile(prof, span_names, window_name: str) -> dict:
    """``span_names``: the benchmark's range names; ``window_name`` the
    range around the whole profiled pass. Returns busy and window seconds,
    kernel seconds by name, the kernel count, the top device operations
    and the idle seconds by innermost host span."""
    device, ranges, window = [], [], None
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name not in span_names and e.name != window_name:
                device.append((t0, t1, e.name))
        elif e.name == window_name:
            window = (t0, t1)
        elif e.name in span_names:
            ranges.append((t0, t1, e.name))
    if window is None:
        return {}
    kernels = defaultdict(float)
    ops = defaultdict(float)
    launches = 0
    for t0, t1, name in device:
        ops[_name(name)] += (t1 - t0) / 1e6
        if not name.startswith(("Memcpy", "Memset")):
            kernels[name] += (t1 - t0) / 1e6
            launches += 1
    # busy: the union of device intervals inside the window
    busy, gaps = 0.0, []
    cursor = window[0]
    for t0, t1, _ in sorted(device):
        t0, t1 = max(t0, window[0]), min(t1, window[1])
        if t1 <= cursor:
            continue
        if t0 > cursor:
            gaps.append((cursor, t0))
            cursor = t0
        busy += t1 - cursor
        cursor = t1
    if cursor < window[1]:
        gaps.append((cursor, window[1]))
    idle = _idle_by_span(gaps, ranges)
    return {
        "busy_s": busy / 1e6,
        "window_s": (window[1] - window[0]) / 1e6,
        "kernel_s": dict(kernels),
        "kernel_launches": launches,
        "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda x: -x[1])[:TOP],
    }


def _idle_by_span(gaps, ranges):
    """Idle seconds by the innermost host range holding each gap's middle
    (the ranges of one host thread nest)."""
    idle = defaultdict(float)
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    stack, i = [], 0
    for g0, g1 in sorted(gaps):
        t = (g0 + g1) / 2
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        idle[stack[-1][2] if stack else "outside spans"] += (g1 - g0) / 1e6
    return idle
