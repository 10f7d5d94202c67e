"""The kernel seam the solver and the screening rule call.

Each ``*_op`` here sends a CUDA tensor to its hand-written kernel and a CPU
tensor to the kernel's plain PyTorch version; nothing else chooses (no
environment toggle, no fallback from a failed build or launch). The launch
counts show that a run went through the kernels. The ``*_partial_op`` /
``*_finalize_op`` pairs are the partial modes of the margin, sample and
feature-screen kernels, which a sharded run (``core/distributed.py``) calls
on either side of an all-reduce.
"""

from __future__ import annotations

from . import hinge as _hinge
from . import screen as _screen
from .hinge import (  # noqa: F401
    hinge_grad_op,
    margin_finalize_op,
    margin_obj_op,
    margin_partial_op,
)
from .screen import (  # noqa: F401
    pack_sample_scalars,
    pack_shared,
    sample_finalize_op,
    sample_partial_op,
    sample_surplus_op,
    screen_finalize_op,
    screen_partial_op,
    screen_bounds_edpp,
    screen_bounds_from_shared,
    screen_bounds_op,
)

_COUNTERS = (_hinge.LAUNCHES, _screen.LAUNCHES)
_VARIANTS = (_hinge.VARIANTS, _screen.VARIANTS)


def launch_counts() -> dict[str, int]:
    """Kernel launches in this process, by kernel name."""
    out: dict[str, int] = {}
    for counter in _COUNTERS:
        out.update(counter)
    return out


def variant_counts() -> dict[str, dict[str, int]]:
    """Launches of each variant (``"bulk"``, ``"scalar"``) of the kernels
    that have two, by kernel name."""
    out: dict[str, dict[str, int]] = {}
    for counter in _VARIANTS:
        out.update({name: dict(v) for name, v in counter.items()})
    return out


def counts_since(before: tuple) -> tuple:
    """``(launches, variants)`` added since ``before``, a
    ``(launch_counts(), variant_counts())`` pair."""
    launches, variants = launch_counts(), variant_counts()
    return ({k: v - before[0][k] for k, v in launches.items()},
            {k: {v: c - before[1][k][v] for v, c in per.items()}
             for k, per in variants.items()})


def add_counts(delta: tuple, times: int = 1) -> None:
    """Add ``times`` x a :func:`counts_since` delta to the counters: a CUDA
    graph counts its launches at capture, where nothing runs, so the graph
    runner takes them back after the capture and adds them at each
    replay."""
    for counter in _COUNTERS:
        for name in counter:
            counter[name] += times * delta[0].get(name, 0)
    for counter in _VARIANTS:
        for name, per in counter.items():
            for v in per:
                per[v] += times * delta[1].get(name, {}).get(v, 0)


def skipped_counts() -> dict[str, int]:
    """Predicated launches of the hinge kernels that did no work (their flag
    was 0), by kernel name; reads the device counters."""
    return _hinge.skipped_counts()


def reset_launch_counts() -> None:
    _hinge.reset_skipped()
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0
    for counter in _VARIANTS:
        for per_variant in counter.values():
            for v in per_variant:
                per_variant[v] = 0
