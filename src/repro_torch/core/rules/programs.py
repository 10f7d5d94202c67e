"""Rule programs: the functional core of the feature-rule zoo.

Port of the reference ``core/rules/programs.py``. Each a-priori-safe
*feature* rule is also a :class:`RuleProgram`, a plain function from a
region (:class:`~repro_torch.core.screening.AnchorStats` anchors and
:class:`~repro_torch.core.screening.FixedStats` statics) to per-feature
bounds; a *stack* of programs is evaluated by taking the elementwise min
of their bounds (the AND of their keeps, the intersection of safe regions).

Contract: ``n_anchors`` is how much anchor history a program reads (1 = the
latest certified anchor, 2 = also the step-before-last), and ``bounds(lam2,
anchors, fixed)`` (anchors oldest to latest) is pure: every reduction over
samples is already in its inputs. The score is the VI rule's, an upper
bound on ``|fhat_j^T theta*(lam2)|``; features with ``bounds < tau`` are
safely dropped.

Programs: ``feature_vi`` (the paper's VI region), ``dvi`` (the min of the
latest and the step-before-last anchors' VI bounds) and ``edpp`` (Wang et
al.'s enhanced-DPP projection ball on the ``y^T theta = 0`` hyperplane,
min-composed with the VI bound of the same anchor, so its keeps are a
subset of VI's; see :func:`~repro_torch.core.screening.edpp_scalars_from_stats`).

These functions are the CPU path, and the plain version the feature-screen
kernel's EDPP mode is held against (``kernels/screen.py``
``screen_bounds_edpp``): on the card the EDPP bound is the same read of X
as the VI bound. :func:`resolve_programs` normalizes a rules spec into a
tuple of program names and raises ``ValueError`` for rules that have none.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from ..screening import (
    AnchorStats,
    FeatureReductions,
    FixedStats,
    edpp_bounds_from_reductions,
    edpp_scalars_from_anchor,
    finalize_from_anchor,
    shared_scalars_from_anchor,
)
from .base import AXIS_FEATURES, make_rules

__all__ = [
    "RuleProgram",
    "PROGRAMS",
    "resolve_programs",
    "stack_bounds",
    "stack_needs_history",
    "max_anchors",
]


class RuleProgram(NamedTuple):
    """A feature rule as pure bounds over precomputed stats."""

    name: str
    n_anchors: int
    bounds: Callable[..., torch.Tensor]  # (lam2, anchors, fixed) -> (m,)


def _vi_bounds(lam2, anchors: Tuple[AnchorStats, ...],
               fixed: FixedStats) -> torch.Tensor:
    """The paper's VI region from the latest anchor."""
    return finalize_from_anchor(anchors[-1], lam2, fixed)


def _dvi_bounds(lam2, anchors: Tuple[AnchorStats, ...],
                fixed: FixedStats) -> torch.Tensor:
    """Min of the latest and the step-before-last VI bounds. The older
    anchor counts only while its ``lam`` exceeds ``lam2``."""
    b = finalize_from_anchor(anchors[-1], lam2, fixed)
    if len(anchors) >= 2:
        a0 = anchors[0]
        b0 = finalize_from_anchor(a0, lam2, fixed)
        below = a0.lam > torch.as_tensor(lam2, dtype=b.dtype, device=b.device)
        b = torch.where(below, torch.minimum(b, b0), b)
    return b


def _edpp_bounds(lam2, anchors: Tuple[AnchorStats, ...],
                 fixed: FixedStats) -> torch.Tensor:
    """EDPP projection ball on the hyperplane, min-composed with the VI
    bound of the same anchor."""
    a = anchors[-1]
    sh = shared_scalars_from_anchor(a, lam2, fixed)
    e = edpp_scalars_from_anchor(a, lam2, fixed)
    red = FeatureReductions(d_theta=a.d_theta, d_one=fixed.d_one,
                            d_y=fixed.d_y, d_sq=fixed.d_sq)
    return edpp_bounds_from_reductions(red, sh, e)


PROGRAMS = {
    "feature_vi": RuleProgram("feature_vi", 1, _vi_bounds),
    "dvi": RuleProgram("dvi", 2, _dvi_bounds),
    "edpp": RuleProgram("edpp", 1, _edpp_bounds),
}


def max_anchors(programs: Sequence[RuleProgram]) -> int:
    return max((p.n_anchors for p in programs), default=1)


def stack_needs_history(programs: Sequence[RuleProgram]) -> bool:
    """Does this stack need the step-before-last anchor carried?"""
    return max_anchors(programs) > 1


def stack_bounds(programs: Sequence, lam2, anchors: Tuple[AnchorStats, ...],
                 fixed: FixedStats) -> torch.Tensor:
    """Elementwise-min bound of a rule stack (the AND of the keeps).

    ``programs`` are :class:`RuleProgram` s or their names; ``anchors`` is
    oldest to latest, and each program sees its most recent ``n_anchors``.
    Valid because every program bounds the same quantity."""
    b = None
    for p in programs:
        p = PROGRAMS[p] if isinstance(p, str) else p
        pb = p.bounds(lam2, anchors[-p.n_anchors:], fixed)
        b = pb if b is None else torch.minimum(b, pb)
    return b


def resolve_programs(spec, screening: bool = True) -> tuple:
    """Normalize a rules spec into a tuple of program names.

    ``None`` defers to ``screening`` (``("feature_vi",)`` or ``()``);
    ``"none"`` and ``""`` disable screening. Anything else is flattened by
    :func:`~repro_torch.core.rules.base.make_rules`, and each rule must name
    a registered program through its ``program`` attribute, screen
    features and need no verification: otherwise ``ValueError`` names the
    offending rules. Duplicates are dropped, in order. ``"auto"`` resolves
    to ``("edpp",)``: its telemetry exists only in ``PathDriver``."""
    if spec is None:
        return ("feature_vi",) if screening else ()
    if isinstance(spec, str) and spec.lower() in ("none", ""):
        return ()
    names, bad = [], []
    for r in make_rules(spec):
        prog = getattr(r, "program", None)
        if (prog is None or prog not in PROGRAMS
                or r.axis != AXIS_FEATURES or r.needs_verification):
            bad.append(r.name)
        else:
            names.append(prog)
    if bad:
        raise ValueError(
            "rule programs cover a-priori-safe feature rules only "
            f"(programs: {tuple(sorted(PROGRAMS))}); cannot lower rule(s) "
            f"{bad!r}: rules that need verification or screen samples run "
            "on the host engine only")
    return tuple(dict.fromkeys(names))
