"""The kernel seam the solver and the screening rule call.

Each ``*_op`` here sends a CUDA tensor to its hand-written kernel and a CPU
tensor to the kernel's plain PyTorch version; nothing else chooses (no
environment toggle, no fallback from a failed build or launch). The launch
counts show that a run went through the kernels.
"""

from __future__ import annotations

from . import hinge as _hinge
from . import screen as _screen
from .hinge import hinge_grad_op, margin_obj_op  # noqa: F401
from .screen import (  # noqa: F401
    pack_sample_scalars,
    pack_shared,
    sample_surplus_op,
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


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for name in counter:
            counter[name] = 0
    for counter in _VARIANTS:
        for per_variant in counter.values():
            for v in per_variant:
                per_variant[v] = 0
