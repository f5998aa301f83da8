"""Reduction of one torch.profiler trace to the numbers the per-layer
metrics read.

`summarize` keeps the arithmetic of profile_torch_track.py's
`trace_summary` (profile_torch_track.py:62-94): it reads the profiler's raw
kineto events (an event tree takes minutes for a tracked frame), sums each
CUDA kernel's device time by name and counts the kernels. Three changes:
busy time is the union of the device intervals, so overlapping operations
are not counted twice; the idle gaps between device operations are
attributed to what the host was doing, the innermost host event running at
each gap's midpoint; and a named range is read on the device, where the
profiler marks it from the start of its first kernel to the end of its
last, not on the host, where it would time the enqueue and whatever waits
fall inside it.

The profiler's own host overhead lengthens the traced wall time, so an
idle share read from a trace is an upper bound on the unprofiled one.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import NamedTuple


class Event(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int
    on_device: bool
    annotation: bool


def kineto_events(prof) -> list[Event]:
    """The raw events of a finished torch.profiler.profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [Event(ev.name(), ev.start_ns(), ev.duration_ns(), ev.device_type() == cuda,
                  ev.is_user_annotation())
            for ev in prof.profiler.kineto_results.events()]


def _union(intervals):
    """Sorted, merged [start, end] intervals and their total length."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged, sum(e - s for s, e in merged)


def summarize(events: list[Event], wall_s: float, ranges=(), top: int = 10) -> dict:
    """Device busy seconds (union of device operations), kernels and their
    device seconds by name, device seconds of the named `ranges` (the union
    of each one's device-side spans, so a range nested in one of its own
    name counts once), and the longest idle gaps by the host event at their
    midpoint, over a traced window of `wall_s` seconds."""
    by_kernel = defaultdict(float)
    spans = defaultdict(list)
    device, host = [], []
    n_kernels = 0
    for ev in events:
        end = ev.start_ns + ev.dur_ns
        if ev.on_device and ev.annotation:
            if ev.name in ranges:
                spans[ev.name].append((ev.start_ns, end))
        elif ev.on_device:
            by_kernel[ev.name] += ev.dur_ns / 1e9
            n_kernels += 1
            device.append((ev.start_ns, end))
        else:
            host.append((ev.start_ns, end, ev.name))
    merged, busy_ns = _union(device)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": wall_s,
        "idle_share": 1.0 - (busy_ns / 1e9) / wall_s if wall_s > 0 else None,
        "kernels": n_kernels,
        "kernel_s": dict(by_kernel),
        "device_range_s": {name: _union(iv)[1] / 1e9 for name, iv in spans.items()},
        "device_ops": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": _gaps_by_host(gaps, host)[:top],
    }


def _gaps_by_host(gaps, host):
    """[(host event name, idle seconds)] summed over gaps, longest first.
    A gap belongs to the innermost host event (the latest started) that is
    running at its midpoint; one sweep over both lists in time order."""
    host = sorted(host)
    heap, j, total = [], 0, defaultdict(float)
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        total[heap[0][2] if heap else "(no host event)"] += (g1 - g0) / 1e9
    return sorted(total.items(), key=lambda kv: -kv[1])


def kernel_seconds(summary: dict, fragment: str) -> float:
    """Device seconds of the kernels whose names contain `fragment`."""
    return sum(v for k, v in summary["kernel_s"].items() if fragment in k)
