"""Dual-side quantities for the L1-regularized L2-loss (squared hinge) SVM.

Port of the reference ``core/dual.py``. Primal (paper Eq. 1):

    min_{w,b}  1/2 sum_i max(0, 1 - y_i (w^T x_i + b))^2 + lam * ||w||_1

``X`` is ``(m, n)`` = (features, samples); ``y in {-1,+1}^n``. Scaled dual
variable ``theta = alpha / lam`` (paper Eq. 19). The X products here are
plain GEMVs (``torch.mv``), as the reference leaves them to XLA outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .screening import row_dot
from .solver import Collectives, _identity, is_local

__all__ = [
    "safe_theta_and_delta",
    "bias_at_lambda_max",
    "lambda_max",
    "first_features",
    "theta_at_lambda_max",
    "xi_from_primal",
    "theta_from_primal",
    "primal_objective",
    "dual_objective",
    "duality_gap_estimate",
    "GapEstimate",
    "bias_at_lambda_max_sharded",
    "lambda_max_sharded",
    "theta_at_lambda_max_sharded",
]


def bias_at_lambda_max(y: torch.Tensor) -> torch.Tensor:
    """Optimal bias when ``w = 0``: ``b* = (n+ - n-)/n`` (paper Sec. 4)."""
    return torch.mean(y)


def lambda_max(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Smallest ``lam`` with ``w*(lam) = 0``: ``|| X (y - b*) ||_inf`` (Eq. 26)."""
    return torch.max(torch.abs(row_dot(X, y - bias_at_lambda_max(y))))


def first_features(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Index of the first feature to enter the model (paper Sec. 5)."""
    return torch.argmax(torch.abs(torch.mv(X, y - bias_at_lambda_max(y))))


def theta_at_lambda_max(y: torch.Tensor, lam_max) -> torch.Tensor:
    """Closed-form dual point at ``lam_max``: ``(1 - y b*) / lam_max``
    (paper Eq. 20 with w = 0; ``theta^T y = 0`` holds exactly)."""
    return (1.0 - y * bias_at_lambda_max(y)) / lam_max


def xi_from_primal(X, y, w, b) -> torch.Tensor:
    """Hinge slack ``xi_i = max(0, 1 - y_i (w^T x_i + b))`` (paper Eq. 20)."""
    margins = y * (torch.mv(X.t(), w) + b)
    return torch.clamp_min(1.0 - margins, 0.0)


def theta_from_primal(X, y, w, b, lam) -> torch.Tensor:
    """``theta = xi / lam`` (paper Eq. 20)."""
    return xi_from_primal(X, y, w, b) / lam


def primal_objective(X, y, w, b, lam) -> torch.Tensor:
    xi = xi_from_primal(X, y, w, b)
    return 0.5 * torch.sum(xi * xi) + lam * torch.sum(torch.abs(w))


def dual_objective(alpha: torch.Tensor) -> torch.Tensor:
    """``D(alpha) = sum_i alpha_i - 1/2 sum_i alpha_i^2`` (paper Eq. 13/16)."""
    return torch.sum(alpha) - 0.5 * torch.sum(alpha * alpha)


class GapEstimate(NamedTuple):
    gap: torch.Tensor
    primal: torch.Tensor
    dual: torch.Tensor
    alpha: torch.Tensor  # the dual-feasible point achieving ``dual``

    @property
    def theta_radius(self) -> torch.Tensor:
        """``||theta_feas - theta*|| <= sqrt(2 gap)/lam`` by 1-strong
        concavity of D(alpha); divide by lam at the call site."""
        return torch.sqrt(2.0 * torch.clamp_min(self.gap, 0.0))


def _feasibility_scale(X, y, alpha, lam) -> torch.Tensor:
    corr = torch.mv(X, y * alpha)  # fhat_j^T alpha for all j
    return torch.clamp_max(lam / torch.clamp_min(torch.max(torch.abs(corr)), 1e-30), 1.0)


def duality_gap_estimate(X, y, w, b, lam, n_feas_iters: int = 2) -> GapEstimate:
    """Approximate duality gap via feasibility projection of ``alpha = xi``.

    Alternates (a) a rescale so ``max_j |fhat_j^T alpha| <= lam`` and (b) the
    ``alpha^T y = 0`` projection clipped to stay nonnegative, then rescales
    once more so the inequality constraints hold for sure.
    """
    alpha = xi_from_primal(X, y, w, b)
    p_obj = 0.5 * torch.sum(alpha * alpha) + lam * torch.sum(torch.abs(w))
    n = y.shape[0]
    for _ in range(n_feas_iters):
        alpha = alpha * _feasibility_scale(X, y, alpha, lam)
        alpha = torch.clamp_min(alpha - (alpha @ y) / n * y, 0.0)
    alpha = alpha * _feasibility_scale(X, y, alpha, lam)
    d_obj = dual_objective(alpha)
    return GapEstimate(gap=p_obj - d_obj, primal=p_obj, dual=d_obj, alpha=alpha)


def safe_theta_and_delta(X, y, w, b, lam, n_feas_iters: int = 8):
    """``(theta1, delta)`` for screening from an approximate primal solution.

    ``theta1`` is a (near-)dual-feasible point; ``delta`` upper-bounds
    ``||theta1 - theta*||`` by 1-strong concavity of the dual plus a slack for
    the residual of the ``alpha^T y = 0`` equality. Both stay on X's device.
    """
    est = duality_gap_estimate(X, y, w, b, lam, n_feas_iters=n_feas_iters)
    n = y.shape[0]
    eq_resid = torch.abs(est.alpha @ y) / torch.sqrt(
        torch.as_tensor(float(n), dtype=y.dtype, device=y.device))
    delta = (est.theta_radius + 2.0 * eq_resid) / lam
    return est.alpha / lam, delta


# -- sharded forms: X, y and theta are a rank's blocks of a grid -------------
# (core/distributed.py); ``col`` its reductions, ``n_total`` the samples of
# the whole X. The reference computes these on the whole X before its
# shard_map; a rank here holds only its block. A local ``col`` runs the
# single-device function.


def bias_at_lambda_max_sharded(y_blk: torch.Tensor, col: Collectives,
                               n_total: int) -> torch.Tensor:
    """``b* = psum_data(sum y) / n`` on every rank (the local mean when the
    sample axis is whole)."""
    if col.psum_data is _identity:
        return bias_at_lambda_max(y_blk)
    return col.psum_data(torch.sum(y_blk)) / float(n_total)


def lambda_max_sharded(X_blk: torch.Tensor, y_blk: torch.Tensor,
                       col: Collectives, n_total: int) -> torch.Tensor:
    """``pmax_model |psum_data X_blk (y_blk - b*)|`` on every rank."""
    if is_local(col):
        return lambda_max(X_blk, y_blk)
    b = bias_at_lambda_max_sharded(y_blk, col, n_total)
    corr = col.psum_data(row_dot(X_blk, y_blk - b))
    return col.pmax_model(torch.max(torch.abs(corr)))


def theta_at_lambda_max_sharded(y_blk: torch.Tensor, lam_max, col: Collectives,
                                n_total: int) -> torch.Tensor:
    """The rank's block of the closed-form dual point at ``lam_max``."""
    if is_local(col):
        return theta_at_lambda_max(y_blk, lam_max)
    return (1.0 - y_blk * bias_at_lambda_max_sharded(y_blk, col, n_total)) / lam_max
