"""DVI rule: feature screening from a pair of anchors (port of the
reference ``core/rules/dvi.py``).

Along a path every solved dual point is a valid anchor: the VI set built
from the step-before-last point ``theta(lam0)`` (with its own radius
``delta0``) also contains ``theta*(lam2)`` whenever ``lam0 > lam2``. Each
set's bound is a valid upper bound on ``|fhat_j^T theta*(lam2)|``, so their
elementwise minimum is too (the "DVI" composition of Liu et al., "Safe
Screening with Variational Inequalities and Its Application to Lasso").

On a CUDA X a screened step is two launches of the feature-screen kernel,
one per anchor. Stateful like the sample rule: ``bounds`` remembers the
incoming region's anchor for the next step, and ``prepare`` forgets it, so
the first screened step of a path, with one anchor only, is exactly
``feature_vi``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...kernels.ops import screen_bounds_from_shared
from ..screening import SAFE_TAU, shared_scalars
from .base import ConvexRegion, register_rule
from .feature_vi import FeatureVIRule

__all__ = ["DVIRule"]


@register_rule("dvi")
class DVIRule(FeatureVIRule):
    """The min of the last and the step-before-last anchors' VI bounds.
    A-priori safe (each bound is). Its program is ``PROGRAMS["dvi"]``
    (two anchors)."""

    program = "dvi"

    def __init__(self, tau: float = SAFE_TAU):
        super().__init__(tau=tau)
        self._anchor: Optional[tuple] = None  # (lam0, theta0, delta0)

    def prepare(self, X: torch.Tensor, y: torch.Tensor) -> None:
        self._anchor = None

    def bounds(self, X: torch.Tensor, y: torch.Tensor,
               region: ConvexRegion) -> torch.Tensor:
        b = super().bounds(X, y, region)
        # the older anchor certifies theta*(lam2) only when screening down
        # from it (lam0 > lam2); a replayed or rising step invalidates it
        if self._anchor is not None and self._anchor[0] > region.lam2:
            lam0, theta0, delta0 = self._anchor
            sh0 = shared_scalars(y, lam0, region.lam2, theta0, delta=delta0)
            b = torch.minimum(b, screen_bounds_from_shared(X, y, theta0, sh0))
        self._anchor = (region.lam1, region.theta1, region.delta)
        return b
