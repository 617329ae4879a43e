"""Metrics registry: counters, timers, distribution summaries.

Reference counterpart: ``api/MicrometerProfiler.java`` — Micrometer Timers +
DistributionSummaries for client/server latency and ratio distributions
(:36-80).  No Micrometer here; a dependency-free registry with the same
observable surface (count / total / mean / percentiles) and a text export.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field


@dataclass
class Summary:
    """Streaming distribution summary with bounded sample reservoir."""

    count: int = 0
    total: float = 0.0
    min: float = math.inf
    max: float = -math.inf
    _samples: list[float] = field(default_factory=list)
    _cap: int = 4096

    def record(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if len(self._samples) < self._cap:
            self._samples.append(value)
        else:  # reservoir sampling keeps percentiles unbiased
            import random
            j = random.randrange(self.count)
            if j < self._cap:
                self._samples[j] = value

    def record_many(self, values) -> None:
        """Vectorized bulk record (numpy array) — one pass for the
        count/total/min/max updates, per-value work only for the bounded
        reservoir."""
        n = len(values)
        if not n:
            return
        vmin, vmax = float(values.min()), float(values.max())
        self.min = min(self.min, vmin)
        self.max = max(self.max, vmax)
        self.total += float(values.sum())
        room = self._cap - len(self._samples)
        if room >= n:
            self._samples.extend(float(v) for v in values)
            self.count += n
        else:
            for v in values:          # reservoir path, rare
                self.count += 1
                if len(self._samples) < self._cap:
                    self._samples.append(float(v))
                else:
                    import random
                    j = random.randrange(self.count)
                    if j < self._cap:
                        self._samples[j] = float(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        idx = min(len(s) - 1, max(0, int(round(p / 100 * (len(s) - 1)))))
        return s[idx]


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, float] = {}
        self.summaries: dict[str, Summary] = {}

    def count(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + delta

    def record(self, name: str, value: float) -> None:
        with self._lock:
            self.summaries.setdefault(name, Summary()).record(value)

    def record_many(self, name: str, values) -> None:
        with self._lock:
            self.summaries.setdefault(name, Summary()).record_many(values)

    def timer(self, name: str):
        """Context manager recording elapsed ms into a summary."""
        registry = self

        class _Timer:
            def __enter__(self):
                import time
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                import time
                registry.record(name, (time.perf_counter() - self.t0) * 1e3)
                return False

        return _Timer()

    def export_text(self) -> str:
        lines = []
        with self._lock:
            for name in sorted(self.counters):
                lines.append(f"counter {name} {self.counters[name]:.0f}")
            for name in sorted(self.summaries):
                s = self.summaries[name]
                lines.append(
                    f"summary {name} count={s.count} mean={s.mean:.3f} "
                    f"min={s.min:.3f} max={s.max:.3f} "
                    f"p50={s.percentile(50):.3f} p95={s.percentile(95):.3f} "
                    f"p99={s.percentile(99):.3f}")
        return "\n".join(lines) + "\n"
