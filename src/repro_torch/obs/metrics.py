"""Counters / gauges / histograms with a registry and a JSON-ready
snapshot (docs/observability.md).

One registry lock guards instrument *creation*; each instrument guards
its own updates.  The histogram keeps a bounded window of recent
observations (plus count/sum/min/max over the full stream), and its
``percentile`` follows numpy's default linear interpolation.  The
Prometheus text export of the reference waits for the observability
slice.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


def _label_key(name: str, labels: Dict[str, Any]) -> Tuple:
    return (name,) + tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"'
                          for k, v in sorted(labels.items())) + "}"


class Counter:
    """Monotonically increasing count (events, tokens, bytes...)."""

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (queue depth, healthy replicas...)."""

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Distribution over a bounded window of recent observations."""

    def __init__(self, name: str, labels: Optional[Dict] = None,
                 window: int = 2048):
        self.name = name
        self.labels = dict(labels or {})
        self.window = window
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._samples.append(v)
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentile(self, q: float) -> float:
        """q in [0, 100], numpy's default linear interpolation."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        with self._lock:
            xs = sorted(self._samples)
        if not xs:
            return 0.0
        rank = (q / 100.0) * (len(xs) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (rank - lo) * (xs[hi] - xs[lo])

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if self._count else 0.0
            mx = self._max if self._count else 0.0
        return {"count": count, "sum": total, "min": mn, "max": mx,
                "mean": (total / count if count else 0.0),
                "p50": self.percentile(50.0), "p99": self.percentile(99.0)}


class MetricsRegistry:
    """name (+ labels) -> instrument.  Asking twice returns the same
    instrument; asking with a different type for an existing name raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple, Any] = {}

    def _get(self, cls, name: str, labels: Dict, **kw):
        key = _label_key(name, labels)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels, **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r}{_label_str(labels)} already "
                    f"registered as {type(inst).__name__}, not "
                    f"{cls.__name__}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, window: int = 2048,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, window=window)

    def instruments(self) -> List[Any]:
        with self._lock:
            return list(self._instruments.values())

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dict: metric name (+labels) -> value / histogram
        summary."""
        out: Dict[str, Any] = {}
        for inst in self.instruments():
            key = inst.name + _label_str(inst.labels)
            out[key] = (inst.snapshot() if isinstance(inst, Histogram)
                        else inst.value)
        return dict(sorted(out.items()))
