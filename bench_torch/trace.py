"""Reading a ``torch.profiler`` trace of the measured window.

The device's busy time is the union of every kernel, copy and set on the
card (the projections of the harness's own ranges onto the device's
timeline are left out).  An idle gap is a stretch between two busy
stretches; it is named by the innermost of the harness's ``bench.*``
ranges that the host was in at the gap's middle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    window_s: float
    busy_s: float = 0.0
    device_ops: list = field(default_factory=list)   # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)    # [[label, seconds]]
    kernel_s: dict = field(default_factory=dict)     # name -> seconds
    span_device_s: dict = field(default_factory=dict)  # span -> seconds


def union_length(intervals: list[tuple[float, float]]) -> tuple[float, list]:
    """(total length, merged intervals in order) of ``intervals``."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def label_at(spans: list[tuple[float, float, str]], t: float) -> str:
    """The innermost (latest-starting) span covering ``t``."""
    best = None
    for s, e, name in spans:
        if s <= t <= e and (best is None or s >= best[0]):
            best = (s, name)
    return best[1] if best else "host, outside every bench span"


def summarize(events, window_s: float, top: int = 10) -> Trace:
    """A :class:`Trace` from ``prof.events()``.  Times in the events are
    microseconds from the trace's start."""
    from torch.autograd import DeviceType

    tr = Trace(window_s=window_s)
    busy, spans = [], []
    for ev in events:
        name = ev.name
        if ev.device_type == DeviceType.CUDA:
            if ev.is_user_annotation or name.startswith(SPAN_PREFIX):
                continue
            s, e = ev.time_range.start, ev.time_range.end
            busy.append((s, e))
            tr.kernel_s[name] = tr.kernel_s.get(name, 0.0) + (e - s) * 1e-6
        elif name.startswith(SPAN_PREFIX):
            spans.append((ev.time_range.start, ev.time_range.end, name))
            tr.span_device_s[name] = tr.span_device_s.get(name, 0.0) \
                + ev.device_time_total * 1e-6
    total, merged = union_length(busy)
    tr.busy_s = total * 1e-6
    tr.device_ops = [[n, s] for n, s in sorted(
        tr.kernel_s.items(), key=lambda kv: -kv[1])[:top]]
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(merged, merged[1:])), reverse=True)[:top]
    tr.idle_gaps = [[label_at(spans, (s + e) / 2), g * 1e-6]
                    for g, s, e in gaps]
    return tr
