"""What the metric readers in ``metrics/`` share: each reader is one call
of one of these, so that a metric's definition is its own small file."""

from __future__ import annotations

import numpy as np

from . import roofline

# the code_hamming kernels: the sweep's pre-pass and sweep, and the gather
HAMMING_KERNELS = ("span_kernel", "sweep_kernel", "gather_kernel")


def mean_stat(run, kind: str, field: str, scale: float = 1.0):
    """Mean of a ``SearchStats`` field over the window's queries, times
    ``scale``, in a cell whose requests are ``kind``."""
    if run.kind != kind or not run.stats:
        return None
    return float(np.mean([getattr(s, field) for s in run.stats])) * scale


def scan_roofline(run, kind: str):
    """Stage A's least time over its device time, in %: the route's calls
    of the traced window against the device time under ``route_batch``
    (the profiler's, else CUDA events around the same calls)."""
    if run.kind != kind or run.trace is None or not run.route_calls \
            or run.program["runtime"].get("routing_mode") != "scan":
        return None
    least, by = 0.0, set()
    for q, n, bits, limit in run.route_calls:
        s, b = roofline.scan_bound_s(q, n, bits, limit)
        least += s
        by.add(b)
    device_s = run.trace.span_device_s.get("bench.route_batch", 0.0)
    source = "profiler"
    if device_s <= 0 and run.route_event_ms:
        device_s, source = run.route_event_ms * 1e-3, "CUDA events"
    if device_s <= 0:
        return None
    run.note(f"scan roofline ({kind}): {len(run.route_calls)} calls, least "
             f"{least * 1e3:.4f} ms by {'/'.join(sorted(by))} against "
             f"{device_s * 1e3:.4f} ms of device time ({source}; CUDA "
             f"events {run.route_event_ms or 0:.4f} ms)")
    return 100.0 * least / device_s


def rerank_roofline(run):
    """``code_hamming``'s least time over its kernels' device time, in %."""
    if run.trace is None or not run.rerank_calls:
        return None
    device_s = sum(s for name, s in run.trace.kernel_s.items()
                   if any(k in name for k in HAMMING_KERNELS))
    if device_s <= 0:
        return None
    least = sum(roofline.hamming_bound(d, w, q, i)[1]
                for d, w, q, i in run.rerank_calls) * 1e-3
    run.note(f"rerank roofline: {len(run.rerank_calls)} launches, least "
             f"{least * 1e3:.4f} ms (bytes) against {device_s * 1e3:.4f} ms")
    return 100.0 * least / device_s


def idle_share(run, kind: str):
    """Share of the traced window with nothing on the card, in %."""
    if run.kind != kind or run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
