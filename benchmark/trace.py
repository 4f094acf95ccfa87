"""The traced run's readings, from one torch.profiler recording's raw
(kineto) events: what ran on the device and when, the runtime's launch
calls, and the host's activity in the device's idle gaps.

The harness wraps the window in a ``bench:window`` range and each call in
``bench:call``; the system may open ``phase:<label>`` ranges inside a
call. The device is busy where a kernel, a copy or a set runs: the union
of their intervals (overlapping kernels count once). An idle gap is named
by the innermost host range on the calling thread at the gap's middle,
under the phase that holds it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

TOP = 10
NAME_CHARS = 80


@dataclass
class Reading:
    calls: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: float = 0.0          # summed kernel durations
    kernels: int = 0
    launches: int = 0              # kernel-launch API calls
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _get(e, attr, default=None):
    """An event's attribute where this torch version has it (older events
    lack ``activity_type``, and some ``start_ns``)."""
    f = getattr(e, attr, None)
    return f() if callable(f) else default


def _span_ns(e):
    start = _get(e, "start_ns")
    if start is None:
        start = _get(e, "start_us") * 1000
    dur = _get(e, "duration_ns")
    if dur is None:
        dur = _get(e, "duration_us") * 1000
    return start, start + dur


def _device_kind(e) -> str:
    """kernel, copy or None (a range's copy on the device timeline), by
    the activity type where the event has one, else by name."""
    kind = _get(e, "activity_type", "")
    name = e.name()
    if kind in ("gpu_memcpy", "gpu_memset") or name.startswith(("Memcpy", "Memset")):
        return "copy"
    if kind == "gpu_user_annotation" or name.startswith(("bench:", "phase:")):
        return None
    return "kernel"


def _is_launch(name: str) -> bool:
    return ("Launch" in name and "Kernel" in name) or name == "cudaGraphLaunch"


def union(intervals) -> List[Tuple[int, int]]:
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read(events, is_cuda) -> Reading:
    """``events``: the profiler's raw events; ``is_cuda(e)``: whether an
    event ran on the device."""
    r = Reading()
    window = None
    calls, host, device = [], [], []
    for e in events:
        name = e.name()
        if is_cuda(e):
            kind = _device_kind(e)
            if kind is not None:
                device.append((kind, name, *_span_ns(e)))
        elif name == "bench:window":
            window = _span_ns(e)
        else:
            if name == "bench:call":
                calls.append(e)
            host.append(e)
    if window is None:
        return r
    w0, w1 = window
    r.window_s = (w1 - w0) / 1e9
    r.calls = len(calls)
    thread = _get(calls[0], "start_thread_id") if calls else None

    spans, by_name = [], {}
    for kind, name, a, b in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        spans.append((a, b))
        key = name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e9
        if kind == "kernel":
            r.kernels += 1
            r.kernel_s += (b - a) / 1e9
    busy = union(spans)
    r.busy_s = sum(b - a for a, b in busy) / 1e9
    r.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    mine = []
    for e in host:
        a, b = _span_ns(e)
        if b <= w0 or a >= w1:
            continue
        if _is_launch(e.name()):
            r.launches += 1
        if thread is None or _get(e, "start_thread_id") == thread:
            mine.append((a, b, e.name()))
    r.idle_gaps = _name_gaps(busy, (w0, w1), mine)
    return r


def _name_gaps(busy, window, ranges) -> List[Tuple[str, float]]:
    """The idle seconds by what the host was doing: each gap between busy
    intervals named by the innermost range over its middle."""
    w0, w1 = window
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    ranges.sort(key=lambda x: (x[0], -x[1]))
    stack, i, totals = [], 0, {}
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while i < len(ranges) and ranges[i][0] <= mid:
            stack.append(ranges[i])
            i += 1
        open_ = [x for x in stack if x[1] > mid]
        stack = open_
        phase = next((x[2][6:] for x in reversed(open_) if x[2].startswith("phase:")), None)
        inner = next((x[2] for x in reversed(open_) if not x[2].startswith("phase:")), None)
        if inner is None:
            label = "between calls"
        elif inner == "bench:call":
            label = "python"
        else:
            label = inner[:NAME_CHARS]
        if phase is not None:
            label = f"{phase}/{label}"
        totals[label] = totals.get(label, 0.0) + (b - a) / 1e9
    return sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
