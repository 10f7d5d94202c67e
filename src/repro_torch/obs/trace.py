"""Low-overhead span recorder exporting Chrome trace-event JSON.

One process-wide :class:`Tracer` (disabled by default) records *spans* —
named, attributed intervals — and *instant events*. The recorder is built
for the port's host loops (``PathDriver.run`` and ``_run_chunked``, the
streamed solver and screen): when disabled, :func:`span` returns a shared
no-op singleton and records nothing (no event allocation, no lock, no
clock read beyond the enabled check), so instrumentation can stay in the
hot path permanently. When enabled, every span costs two
``perf_counter`` reads and one locked list append — thread-safe (events
carry the recording thread's id). A copy of the reference
``obs/trace.py``.

Export is the Chrome trace-event format (``{"traceEvents": [...]}``),
loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``:
spans become complete events (``ph="X"``, microsecond ``ts``/``dur``),
instants become ``ph="i"``, and span attributes ride ``args``.

Enable programmatically (:func:`enable`) or via ``REPRO_TRACE=1`` in the
environment; ``train_svm --trace out.json`` wires both ends together.

The on-device engines (scan/batched/sharded scan) record one dispatch
span and synthesize their per-step spans post-hoc from the telemetry they
return: see ``repro_torch.obs.path_trace.PathTrace.emit_to_tracer``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

__all__ = [
    "Tracer",
    "span",
    "instant",
    "complete",
    "enable",
    "disable",
    "enabled",
    "get_tracer",
    "export_chrome",
]


class _NoopSpan:
    """Shared do-nothing span: the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs):
        """Attach/overwrite attributes mid-span (e.g. iteration counts
        known only at the end of the timed region)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._record(self.name, self._t0, t1 - self._t0, self.attrs)
        return False


class Tracer:
    """Thread-safe span/event recorder with Chrome trace-event export.

    All timestamps are relative to the tracer's epoch (construction or the
    most recent :meth:`clear`), in seconds; export converts to the
    microseconds the trace-event format wants.
    """

    def __init__(self, enabled: bool = False, process_name: str = "repro_torch"):
        self._enabled = bool(enabled)
        self.process_name = process_name
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._epoch = time.perf_counter()

    # -- state -------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def clear(self):
        with self._lock:
            self._events = []
            self._epoch = time.perf_counter()

    def now(self) -> float:
        """Seconds since the tracer epoch."""
        return time.perf_counter() - self._epoch

    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager timing a named interval; no-op when disabled."""
        if not self._enabled:
            return NOOP_SPAN
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs):
        """Record a zero-duration marker event; no-op when disabled."""
        if not self._enabled:
            return
        self._append({
            "name": name, "ph": "i", "s": "t",
            "ts": self.now() * 1e6,
            "tid": threading.get_ident(),
            "args": attrs,
        })

    def _record(self, name, t0, dur_s, attrs):
        self._append({
            "name": name, "ph": "X",
            "ts": (t0 - self._epoch) * 1e6,
            "dur": dur_s * 1e6,
            "tid": threading.get_ident(),
            "args": attrs,
        })

    def add_complete_event(self, name: str, start_s: float, dur_s: float,
                           tid: int = 0, **attrs):
        """Append a complete ('X') event with explicit relative timing —
        the post-hoc synthesis path for single-dispatch engines (timestamps
        in seconds since the tracer epoch)."""
        if not self._enabled:
            return
        self._append({
            "name": name, "ph": "X",
            "ts": start_s * 1e6, "dur": dur_s * 1e6,
            "tid": tid, "args": attrs,
        })

    def _append(self, ev: dict):
        with self._lock:
            self._events.append(ev)

    # -- export ------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        pid = os.getpid()
        with self._lock:
            events = [dict(ev, pid=pid) for ev in self._events]
        meta = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": self.process_name},
        }]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export_chrome(self, path) -> str:
        """Write the Chrome trace-event JSON to ``path``; returns the path."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome()))
        return str(path)


# -- process-wide tracer ---------------------------------------------------

_TRACER = Tracer(enabled=os.environ.get("REPRO_TRACE", "0") not in
                 ("", "0", "false", "False"))


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER._enabled


def enable():
    _TRACER.enable()


def disable():
    _TRACER.disable()


def span(name: str, **attrs):
    """Module-level ``with span("solve", step=k): ...`` on the process
    tracer — the form the engines thread through their hot loops."""
    if not _TRACER._enabled:
        return NOOP_SPAN
    return _Span(_TRACER, name, attrs)


def instant(name: str, **attrs):
    _TRACER.instant(name, **attrs)


def complete(name: str, t0: float, t1: float, **attrs):
    """Record a complete span from absolute ``perf_counter`` stamps the
    caller already took for its own bookkeeping (the host path loops stamp
    screen/solve/certify walls regardless of tracing) — zero extra clock
    reads, no-op when disabled."""
    if not _TRACER._enabled:
        return
    _TRACER._append({
        "name": name, "ph": "X",
        "ts": (t0 - _TRACER._epoch) * 1e6,
        "dur": (t1 - t0) * 1e6,
        "tid": threading.get_ident(),
        "args": attrs,
    })


def export_chrome(path) -> str:
    return _TRACER.export_chrome(path)
