"""Process-wide metrics registry: counters, gauges, histograms.

A copy of the reference ``obs/metrics.py``. It holds the port's telemetry
counters behind one API: the chunk store's ``FeatureChunked.stats``
(``chunks_streamed`` / ``chunks_skipped`` / ``bytes_put``, mirrored as
``stream.*``), guard trips and kept-per-step (``path.*``). The legacy
dicts keep working (call sites mirror their increments here); the registry
adds the unified view: ``snapshot()`` for structured readers,
:func:`to_json` and :func:`to_prometheus` (text exposition format) for
dumps.

Conventions: dotted lowercase names namespaced by subsystem —
``serve.hits``, ``stream.chunks_skipped``, ``path.guard_trips``,
``engine.cache.retraces`` — with counters for monotonic totals, gauges for
last-observed values, histograms for per-event distributions
(``serve.latency_s``, ``path.kept``). Prometheus output maps dots to
underscores (``repro_serve_hits_total``).

Thread-safe: metric creation and increments take the registry/metric
lock; reads are snapshots, not live views.
"""

from __future__ import annotations

import json
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "absorb",
    "snapshot",
    "reset",
    "to_json",
    "to_prometheus",
]


class Counter:
    """Monotonically increasing integer/float total."""

    kind = "counter"
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self.value += n

    def get(self):
        return self.value

    def reset(self):
        with self._lock:
            self.value = 0


class Gauge:
    """Last-observed value (e.g. occupancy, cache size, a dict snapshot)."""

    kind = "gauge"
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self.value = v

    def set_max(self, v):
        """Keep the running maximum (mirrors ``stats["max_put_rows"]``)."""
        with self._lock:
            if v > self.value:
                self.value = v

    def get(self):
        return self.value

    def reset(self):
        with self._lock:
            self.value = 0


class Histogram:
    """Streaming distribution summary: count / sum / min / max.

    Deliberately bucket-free — the consumers here (bench deltas, serve
    latency percentiles over small job counts) keep the raw observations
    when they need quantiles; the registry's job is the cheap always-on
    aggregate.
    """

    kind = "histogram"
    __slots__ = ("name", "count", "total", "min", "max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def get(self) -> dict:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "min": None, "max": None,
                        "mean": None}
            return {"count": self.count, "sum": self.total,
                    "min": self.min, "max": self.max,
                    "mean": self.total / self.count}

    def reset(self):
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = float("inf")
            self.max = float("-inf")


class MetricsRegistry:
    """Name -> metric map with typed get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def absorb(self, prefix: str, mapping: dict):
        """Set one gauge per key of a legacy stats dict (``prefix.key``) —
        the adapter for dict-shaped telemetry produced elsewhere
        (``engine_cache_info()``, ``PathServer.cache_stats()``)."""
        for k, v in mapping.items():
            self.gauge(f"{prefix}.{k}").set(v)

    def snapshot(self) -> dict:
        """``{name: value}`` for every registered metric (histograms give
        their summary dicts). A plain-data copy — safe to json-dump."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.get() for name, m in sorted(items)}

    def reset(self):
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m.reset()

    # -- dumps -------------------------------------------------------------

    def to_json(self, indent=None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one family per metric)."""
        lines = []
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            base = "repro_" + name.replace(".", "_").replace("-", "_")
            if m.kind == "counter":
                lines.append(f"# TYPE {base}_total counter")
                lines.append(f"{base}_total {m.get()}")
            elif m.kind == "gauge":
                v = m.get()
                if isinstance(v, (int, float)):
                    lines.append(f"# TYPE {base} gauge")
                    lines.append(f"{base} {v}")
            else:  # histogram summary
                s = m.get()
                lines.append(f"# TYPE {base} summary")
                lines.append(f"{base}_count {s['count']}")
                lines.append(f"{base}_sum {s['sum']}")
        return "\n".join(lines) + "\n"


# -- process-wide registry -------------------------------------------------

REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def absorb(prefix: str, mapping: dict):
    REGISTRY.absorb(prefix, mapping)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset():
    REGISTRY.reset()


def to_json(indent=None) -> str:
    return REGISTRY.to_json(indent=indent)


def to_prometheus() -> str:
    return REGISTRY.to_prometheus()
