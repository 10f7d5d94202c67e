"""The paper's variational-inequality feature rule (paper Sec. 6).

Port of the reference ``core/rules/feature_vi.py``. The math lives in
``core/screening.py``; this class owns the policy: the per-feature bound and
the keep threshold. On a CUDA X, :meth:`FeatureVIRule.bounds` is one launch
of the screen kernel (all four reductions and the finalizer from one read
of X); on a CPU X it is the kernel's plain version.
"""

from __future__ import annotations

import torch

from ...kernels.ops import screen_bounds_from_shared
from ..screening import SAFE_TAU
from .base import AXIS_FEATURES, ConvexRegion, ScreeningRule, register_rule

__all__ = ["FeatureVIRule"]


@register_rule("feature_vi")
class FeatureVIRule(ScreeningRule):
    """Safe feature screening: discard feature ``j`` when
    ``max_{theta in K} |fhat_j^T theta| < tau`` (paper Algorithm 1).

    A-priori safe: a discarded feature provably has ``w_j*(lam2) = 0`` given
    ``||theta1 - theta*(lam1)|| <= region.delta``.
    """

    axis = AXIS_FEATURES
    program = "feature_vi"

    def __init__(self, tau: float = SAFE_TAU):
        self.tau = float(tau)

    def bounds(self, X: torch.Tensor, y: torch.Tensor,
               region: ConvexRegion) -> torch.Tensor:
        return screen_bounds_from_shared(X, y, region.theta1, region.shared)

    def keep(self, bounds: torch.Tensor) -> torch.Tensor:
        """NaN-safe: a non-finite bound certifies nothing, so it is kept."""
        return ~(bounds < self.tau)
