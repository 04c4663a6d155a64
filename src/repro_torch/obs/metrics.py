"""Counters / gauges / histograms with a registry, Prometheus-style text
export, and a JSON snapshot (docs/observability.md); the reference's
``obs/metrics.py``.

Everything is in-process and lock-cheap: one registry lock guards
instrument *creation*; each instrument guards its own updates.  The
histogram keeps a bounded window of recent observations (plus running
count/sum/min/max over the full stream), and its ``percentile`` follows
numpy's default linear-interpolation convention exactly — the test suite
holds it to ``np.percentile`` as the oracle.

``Span`` is the timing primitive: a context manager that observes its
elapsed milliseconds into a histogram on exit.  The dependability layers
use spans to *measure* the Young/Daly terms (checkpoint cost C, restore
cost R, detection downtime D) instead of trusting configured estimates —
``CheckpointPolicy.observe_recovery`` consumes them.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


def _label_key(name: str, labels: Dict[str, Any]) -> Tuple:
    return (name,) + tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label(v: Any) -> str:
    """Prometheus label-value escaping: backslash, newline, quote."""
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _label_str(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


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
    """Point-in-time value (queue depth, alive hosts, dp width...)."""

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Distribution over a bounded window of recent observations.

    count/sum/min/max run over the whole stream; percentiles run over the
    newest ``window`` samples (steady-state tail behaviour, bounded
    memory — the same discipline as ``StragglerWatchdog.durations``).
    """

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

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100], numpy's default linear interpolation: the rank
        is ``q/100 * (n-1)`` and fractional ranks interpolate between the
        two nearest order statistics (oracle: ``np.percentile``)."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        with self._lock:
            xs = sorted(self._samples)
        if not xs:
            return 0.0
        rank = (q / 100.0) * (len(xs) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(xs) - 1)
        frac = rank - lo
        return xs[lo] + frac * (xs[hi] - xs[lo])

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if self._count else 0.0
            mx = self._max if self._count else 0.0
        return {"count": count, "sum": total, "min": mn, "max": mx,
                "mean": (total / count if count else 0.0),
                "p50": self.percentile(50.0), "p99": self.percentile(99.0)}


class Span:
    """``with registry.span("checkpoint.critical_path_ms"): ...`` —
    observes elapsed milliseconds into the named histogram on exit.
    ``seconds`` holds the raw duration afterwards (the policy feedback
    path wants seconds, not ms)."""

    def __init__(self, hist: Histogram):
        self.hist = hist
        self.seconds: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        self.hist.observe(self.seconds * 1e3)


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

    def span(self, name: str, **labels) -> Span:
        return Span(self.histogram(name, **labels))

    def instruments(self) -> List[Any]:
        with self._lock:
            return list(self._instruments.values())

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dict: metric name (+labels) -> value / histogram
        summary."""
        out: Dict[str, Any] = {}
        for inst in self.instruments():
            key = inst.name + _label_str(inst.labels)
            if isinstance(inst, (Counter, Gauge)):
                out[key] = inst.value
            else:
                out[key] = inst.snapshot()
        return dict(sorted(out.items()))

    def to_json(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.snapshot(), indent=2, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    def to_prometheus(self, quantiles: Tuple[float, ...] = (0.5, 0.99)
                      ) -> str:
        """Prometheus text exposition (untyped beyond counter/gauge;
        histograms export _count/_sum plus quantile gauges — precomputed
        client-side quantiles, the summary-metric idiom).  ``quantiles``
        are fractions in [0, 1]; the default (0.5, 0.99) keeps the
        long-standing p50/p99 output byte-identical."""
        for q in quantiles:
            if not 0.0 <= q <= 1.0:
                raise ValueError(f"quantile must be in [0, 1], got {q}")
        lines: List[str] = []
        seen_types: Dict[str, str] = {}
        for inst in sorted(self.instruments(), key=lambda i: i.name):
            base = inst.name.replace(".", "_").replace("-", "_")
            ls = _label_str(inst.labels)
            if isinstance(inst, Counter):
                if seen_types.setdefault(base, "counter") == "counter":
                    if f"# TYPE {base} counter" not in lines:
                        lines.append(f"# TYPE {base} counter")
                lines.append(f"{base}{ls} {inst.value:g}")
            elif isinstance(inst, Gauge):
                if f"# TYPE {base} gauge" not in lines:
                    lines.append(f"# TYPE {base} gauge")
                lines.append(f"{base}{ls} {inst.value:g}")
            else:
                snap = inst.snapshot()
                if f"# TYPE {base} summary" not in lines:
                    lines.append(f"# TYPE {base} summary")
                for q in quantiles:
                    qls = dict(inst.labels, quantile=f"{q:g}")
                    lines.append(
                        f"{base}{_label_str(qls)} "
                        f"{inst.percentile(q * 100.0):g}")
                lines.append(f"{base}_count{ls} {snap['count']:g}")
                lines.append(f"{base}_sum{ls} {snap['sum']:g}")
        return "\n".join(lines) + ("\n" if lines else "")
