"""EDPP rule: Wang et al.'s enhanced-DPP projection region for the SVM dual.

Port of the reference ``core/rules/edpp.py``. The squared-hinge L1-SVM dual
is a projection, ``theta*(lam) = P_Theta((1/lam) 1)``, so with ``o_k =
(1/lam_k) 1`` the direction ``v1 = o1 - theta1`` lies in the normal cone at
``theta1``, and firm non-expansiveness confines ``theta*(lam2)`` to the ball
of center ``theta1 + v2perp/2`` and radius ``||v2perp||/2``, ``v2 = o2 -
theta1``, ``v2perp = v2 - (<v1, v2>/||v1||^2) v1``. The plain DPP ball
(``v2perp -> v2``) is the paper's VI ball; projecting out ``v1`` shrinks
it. The bound needs the same four per-feature reductions as the VI bound,
and is min-composed with the VI bound of the same anchor, so EDPP keeps
are a subset of VI keeps (``core/rules/programs.py``).

On a CUDA X, :meth:`EDPPRule.bounds` is one launch of the feature-screen
kernel in its EDPP mode (``kernels/screen.py`` ``screen_bounds_edpp``):
one read of X, as for ``feature_vi``. On a CPU X it is the ``edpp`` rule
program over the four reductions.
"""

from __future__ import annotations

import torch

from ...kernels.ops import screen_bounds_edpp
from ..screening import edpp_scalars
from .base import ConvexRegion, register_rule
from .feature_vi import FeatureVIRule

__all__ = ["EDPPRule", "edpp_region_bounds"]


def edpp_region_bounds(X: torch.Tensor, y: torch.Tensor,
                       region: ConvexRegion) -> torch.Tensor:
    """The EDPP bound of ``region``'s anchor, targeting ``region.lam2``: the
    EDPP scalars on the anchor's device, then one sweep of X."""
    e = edpp_scalars(y, region.lam1, region.lam2, region.theta1, region.delta)
    return screen_bounds_edpp(X, y, region.theta1, region.shared, e)


@register_rule("edpp")
class EDPPRule(FeatureVIRule):
    """A-priori-safe feature screening from the EDPP projection region,
    min-composed with the VI bound. Drop-in wherever ``feature_vi`` runs."""

    program = "edpp"

    def bounds(self, X: torch.Tensor, y: torch.Tensor,
               region: ConvexRegion) -> torch.Tensor:
        return edpp_region_bounds(X, y, region)
