"""Verified sample screening for the L1-regularized L2-loss SVM.

Port of the reference ``core/rules/sample_vi.py``. A sample ``i`` drops out
of every solver sweep iff its slack vanishes at the target optimum:
``xi_i*(lam2) = max(0, 1 - y_i (w*^T x_i + b*)) = 0``. For the squared
hinge no bounded dual region certifies that a priori (the dual coordinate
``theta_i = xi_i / lam`` is continuous; :func:`sample_slack_caps` is the
best a-priori bound and is too loose to screen), so the rule splits the
guarantee in two:

1. **Margin prediction** (:meth:`SampleVIRule.bounds`). Screen sample ``i``
   when its margin surplus at the previous solution clears a slack budget,
   ``y_i u1_i - 1 >= slack_i`` with ``u1 = X^T w1 + b1``; the slack is the
   smaller of the secant model ``shrink_factor * |u1_i - u0_i| +
   margin_floor`` (``u0``: the margins one anchor earlier, once there is
   history) and the trust-region model ``||x_i|| dw + db``.
2. **KKT verification** (:meth:`SampleVIRule.verify`). At the solved
   reduced point every screened sample's margin is re-checked in float64,
   as the reference checks it; violators are re-admitted and the step
   re-solved (:func:`~repro_torch.core.rules.base.solve_with_verification`).
   On acceptance every screened sample has ``xi_i = 0`` at the returned
   solution: zero false rejections, whatever the slack model predicted.

On a CUDA X, :meth:`SampleVIRule.bounds` is one launch of the sample-axis
kernel (``kernels/csrc/sample.cu``), which gives ``u1`` and ``||x_i||^2``
from one transposed read of X and writes the surplus and ``u1``; on a CPU
X it is the kernel's plain version. That finalizer clamps the total slack
at 1e30, where :func:`margin_surplus_core` clamps ``dw`` and ``db`` one by
one; the two agree wherever the slack is below 1e29.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...kernels.ops import sample_surplus_op
from ..screening import _EPS, _t_max
from ..solver import _identity
from .base import AXIS_SAMPLES, ConvexRegion, ScreeningRule, register_rule

__all__ = ["SampleVIRule", "sample_slack_caps", "sample_margin_surplus",
           "margin_surplus_core", "violators_from_margins", "margins_f64"]

# stands in for the driver's "no movement bound yet" dw/db = inf inside the
# arithmetic: 0 * inf = NaN for a zero-norm sample column
_BIG = 1e30
# elements of X that margins_f64 gathers at a time (32 MB in float64)
_GATHER_ELEMS = 1 << 22


def sample_slack_caps(region: ConvexRegion) -> torch.Tensor:
    """Certified per-sample cap ``xi_i*(lam2) <= lam2 * max_{theta in K}
    theta_i``, in closed form (no sweep of X): the stats of ``v = e_i``
    against the VI set are ``theta1_i``, ``1``, ``y_i`` and ``1``. Valid but
    loose (the region's coordinate extent is O(ball radius)); a diagnostic
    and the a-priori baseline the margin rule beats."""
    sh = region.shared
    y, theta1 = region.y, region.theta1
    v_ch = 0.5 * (sh.inv_lam2 + theta1) - (sh.yc / sh.ysq) * y
    qv_sq = torch.clamp_min(1.0 - y * y / sh.ysq, 0.0)
    v_a = (theta1 - sh.inv_lam1) / torch.clamp_min(sh.a_norm, _EPS)
    qv_qa = v_a - y * sh.a_dot_y / sh.ysq
    return region.lam2 * torch.clamp_min(_t_max(v_ch, qv_qa, qv_sq, sh), 0.0)


def margin_surplus_core(u1, y, x_sq, dw, db, u_prev=None,
                        shrink_factor: float = 2.0,
                        margin_floor: float = 1e-3) -> torch.Tensor:
    """The reference's surplus arithmetic from precomputed margins ``u1``
    (bias included) and column norms ``x_sq``: ``dw`` and ``db`` clamp at
    1e30 one by one, and the secant applies when ``u_prev`` is given."""
    dw = min(float(dw), _BIG)
    db = min(float(db), _BIG)
    slack = torch.sqrt(x_sq) * dw + db  # huge (never screens) until history
    if u_prev is not None:
        slack = torch.minimum(slack,
                              shrink_factor * torch.abs(u1 - u_prev) + margin_floor)
    return y * u1 - 1.0 - slack


def margins_f64(X, w, b, idx) -> torch.Tensor:
    """``x_i^T w + b`` in float64 for the samples ``idx`` (a device tensor
    of column indices), on X's device: the reference's verification sums
    (a numpy float32 X times a float64 ``w``, ``core/path.py``).

    Only the support of ``w`` is read: a term with ``w_j = 0`` is exactly 0
    in float64, so the sum over the support is the reference's sum up to
    float64 rounding, with no fp32 rounding at all (an fp32 margin within
    a few ulps of 1 can fall on either side of it). The ``|supp| x |idx|``
    entries of X are gathered in pieces of at most ``_GATHER_ELEMS``; the
    cost grows with ``nnz(w)``, not with X, and X is never copied to the
    host."""
    dev = X.device
    out = torch.zeros((idx.shape[0],), dtype=torch.float64, device=dev)
    out += torch.as_tensor(b, dtype=torch.float64, device=dev)
    supp = torch.nonzero(w).squeeze(1)
    step = max(1, _GATHER_ELEMS // max(idx.shape[0], 1))
    for lo in range(0, supp.shape[0], step):
        rows = supp[lo:lo + step]
        out += X[rows[:, None], idx[None, :]].double().t() @ w[rows].double()
    return out


def violators_from_margins(y, margins, screened_idx):
    """Screened samples with slack > 0: ``margins[j] = x_i^T w + b`` for
    ``i = screened_idx[j]``."""
    return screened_idx[y[screened_idx] * margins < 1.0]


def sample_margin_surplus(X, y, region: ConvexRegion,
                          u_prev: Optional[torch.Tensor] = None,
                          shrink_factor: float = 2.0,
                          margin_floor: float = 1e-3):
    """``(surplus, u1)`` per sample from one sweep of X (the sample-axis
    kernel on a CUDA X). ``surplus_i >= 0`` predicts ``xi_i*(lam2) = 0``, to
    be verified. Without a primal anchor (``region.w1 is None``) the
    margins are ``b1``."""
    w1 = region.w1
    if w1 is None:
        w1 = torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
    return sample_surplus_op(X, w1, y, region.b1, region.dw, region.db,
                             u_prev=u_prev, shrink_factor=shrink_factor,
                             margin_floor=margin_floor)


@register_rule("sample_vi")
class SampleVIRule(ScreeningRule):
    """Margin-predicted sample screening with a-posteriori KKT verification.

    ``bounds`` returns the margin surplus; ``keep`` keeps every sample whose
    surplus is not certified non-negative (a NaN surplus is kept);
    ``verify`` re-checks screened samples at the solved point. Stateful
    along a path: the rule remembers the last anchor's margins for the
    secant model, and ``prepare`` (once per path) forgets them.
    """

    axis = AXIS_SAMPLES
    needs_verification = True

    def __init__(self, shrink_factor: float = 2.0, margin_floor: float = 1e-3):
        self.shrink_factor = float(shrink_factor)
        self.margin_floor = float(margin_floor)
        self._u_prev: Optional[torch.Tensor] = None

    def prepare(self, X: torch.Tensor, y: torch.Tensor) -> None:
        self._u_prev = None

    def bounds(self, X: torch.Tensor, y: torch.Tensor,
               region: ConvexRegion) -> torch.Tensor:
        surplus, u1 = sample_margin_surplus(
            X, y, region, u_prev=self._u_prev,
            shrink_factor=self.shrink_factor, margin_floor=self.margin_floor)
        self._u_prev = u1
        return surplus

    def keep(self, bounds: torch.Tensor) -> torch.Tensor:
        return ~(bounds >= 0.0)

    def verify(self, X, y, w, b, screened_idx, col=None) -> torch.Tensor:
        """Screened samples whose margin at ``(w, b)`` is below 1, tested
        in float64 over the support of ``w`` on X's device
        (:func:`margins_f64`). ``col`` (a sharded seam,
        ``core/distributed.py``): X is the rank's block and ``w`` its rows;
        the float64 partial margins of the rank's rows are summed over the
        feature axis in float64 before ``b`` is added and the test is made
        (never on fp32 sharded margins)."""
        if col is None or col.psum_model is _identity:
            margins = margins_f64(X, w, b, screened_idx)
        else:
            margins = col.psum_model(margins_f64(X, w, 0.0, screened_idx))
            margins = margins + torch.as_tensor(b, dtype=torch.float64,
                                                device=margins.device)
        return violators_from_margins(y, margins, screened_idx)
