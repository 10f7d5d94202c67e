"""What a ``torch.profiler`` trace of the traced paths says.

The traced window is the host span ``WINDOW`` (a ``record_function``
around the traced paths). The device was busy where any kernel, copy or
memset ran: the union of their intervals, clipped to the window (the
arithmetic of the port's ``scripts/torch_path_profile.py``). Device-side
copies of ``record_function`` annotations are not device work and are left
out. Idle gaps are labelled by what the host was doing at their midpoint:
the innermost annotation and the innermost host operation there.

The events are read raw from the profiler's ``kineto_results``
(:func:`events`): a traced cycle holds millions of launches, and building
the profiler's tree of Python objects for them took minutes.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

WINDOW = "svmbench.traced"
#: gaps labelled one by one (the longest); the rest are summed as one entry
LABELLED_GAPS = 400
TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict                      # device seconds by operation name
    idle_gaps: list = field(default_factory=list)   # [[label, seconds], ...]

    def device_ops(self) -> list:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return [[k, v] for k, v in top]


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to ``[lo, hi]``."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_intervals(intervals, lo: float, hi: float) -> list:
    """The gaps in ``[lo, hi]`` that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a >= hi:
            break
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return gaps


class Event(NamedTuple):
    name: str
    device: str           # "CPU" (the host) or "CUDA"
    start: float          # microseconds
    end: float
    annotation: bool      # a ``record_function`` span or its device copy


def events(prof) -> list:
    """The events of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-3
        ann = getattr(e, "is_user_annotation", None)
        out.append(Event(e.name(), e.device_type().name, start,
                         start + e.duration_ns() * 1e-3, bool(ann and ann())))
    return out


def summarize(evs: list, annotations: set) -> TraceSummary | None:
    """Reads :func:`events`; ``annotations`` are the names of the host's
    ``record_function`` spans (the harness's and the port's), left out of
    the device's work wherever they show. None when the trace holds no
    window."""
    windows = [e for e in evs if e.name == WINDOW and e.device == "CPU"]
    if not windows:
        return None
    lo = min(e.start for e in windows)
    hi = max(e.end for e in windows)
    dev = [e for e in evs if e.device == "CUDA" and not e.annotation
           and e.name not in annotations]
    spans = [(e.start, e.end) for e in dev]
    kernel_s: dict = defaultdict(float)
    for e in dev:
        if e.end > lo and e.start < hi:
            kernel_s[e.name] += (min(e.end, hi) - max(e.start, lo)) * 1e-6
    summary = TraceSummary(window_s=(hi - lo) * 1e-6,
                           busy_s=union_length(spans, lo, hi) * 1e-6,
                           kernel_s=dict(kernel_s))
    if dev:
        summary.idle_gaps = _label_gaps(evs, idle_intervals(spans, lo, hi), annotations)
    return summary


def _label_gaps(evs: list, gaps: list, annotations: set) -> list:
    host = [e for e in evs if e.device == "CPU" and e.name != WINDOW]
    if not gaps or not host:
        return []
    start = np.array([e.start for e in host], np.float64)
    end = np.array([e.end for e in host], np.float64)
    dur = end - start
    is_ann = np.array([e.annotation or e.name in annotations for e in host])
    names = [e.name for e in host]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    totals: dict = defaultdict(float)
    for a, b in gaps[:LABELLED_GAPS]:
        t = 0.5 * (a + b)
        inside = (start <= t) & (end >= t)
        parts = []
        for sel in (inside & is_ann, inside & ~is_ann):
            idx = np.nonzero(sel)[0]
            if idx.size:
                parts.append(names[idx[np.argmin(dur[idx])]])
        totals[" > ".join(parts) or "no host span"] += (b - a) * 1e-6
    rest = sum(b - a for a, b in gaps[LABELLED_GAPS:]) * 1e-6
    if rest > 0:
        totals[f"shorter gaps than the {LABELLED_GAPS} longest"] += rest
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, v] for k, v in top]
