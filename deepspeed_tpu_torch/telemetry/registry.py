"""Labeled metrics primitives: counters, gauges, histograms, spans
(counterpart of ``deepspeed_tpu/telemetry/registry.py``, copied).

The registry is the process-local aggregation layer under the telemetry
hub: every emitted trace event also folds its numeric fields into
histograms here, so ``Telemetry.summary()`` can report p50/p95/max without
re-reading the JSONL file. Dependency-free (stdlib only).
"""

import threading
import time
from collections import deque
from typing import Dict, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]) of a sequence."""
    if not values:
        return 0.0
    vals = sorted(values)
    if len(vals) == 1:
        return float(vals[0])
    rank = (q / 100.0) * (len(vals) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(vals) - 1)
    frac = rank - lo
    return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)


def metric_key(name: str, labels: Optional[dict] = None) -> str:
    """Canonical "name{k=v,...}" key; label order never matters."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter."""

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0):
        self.value += n


class Gauge:
    """Last-value-wins scalar."""

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Running count/sum/min/max plus a bounded reservoir of recent
    observations for percentiles (long-running servers must not grow
    unboundedly; the window covers the recent behavior operators ask
    about)."""

    def __init__(self, reservoir: int = 4096):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._values = deque(maxlen=reservoir)

    def observe(self, v: float):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._values.append(v)

    def snapshot(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0}
        vals = list(self._values)
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.sum / self.count,
            "p50": percentile(vals, 50.0),
            "p95": percentile(vals, 95.0),
        }


class _Span:
    """Context manager timing a block into ``histogram(name, labels)`` in
    milliseconds (and counting entries via the histogram count)."""

    def __init__(self, registry: "MetricsRegistry", name: str, labels: Optional[dict]):
        self._registry = registry
        self._name = name
        self._labels = labels
        self.elapsed_ms = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        # host-side span primitive: callers timing device work own the sync
        # (engines block_until_ready under telemetry.sync_timers before the
        # span closes)  # ds-lint: disable=unsynced-timing
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1000.0
        self._registry.histogram(self._name, self._labels).observe(self.elapsed_ms)
        return False


class MetricsRegistry:
    """Process-local labeled metrics store.

    >>> reg = MetricsRegistry()
    >>> reg.counter("requests", {"path": "fused"}).inc()
    >>> reg.gauge("loss_scale").set(65536.0)
    >>> with reg.span("step_ms"):
    ...     pass
    >>> reg.dump()["counters"]["requests{path=fused}"]
    1.0
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        key = metric_key(name, labels)
        with self._lock:
            return self._counters.setdefault(key, Counter())

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        key = metric_key(name, labels)
        with self._lock:
            return self._gauges.setdefault(key, Gauge())

    def histogram(self, name: str, labels: Optional[dict] = None) -> Histogram:
        key = metric_key(name, labels)
        with self._lock:
            return self._histograms.setdefault(key, Histogram())

    def span(self, name: str, labels: Optional[dict] = None) -> _Span:
        return _Span(self, name, labels)

    def dump(self) -> dict:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self._counters.items()},
                "gauges": {k: g.value for k, g in self._gauges.items()},
                "histograms": {k: h.snapshot() for k, h in self._histograms.items()},
            }
