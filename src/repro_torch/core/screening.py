"""Safe feature screening for the L1-regularized L2-loss SVM (paper Sec. 6).

Port of the reference ``core/screening.py``. Given the dual optimum
``theta1`` at ``lam1`` and a target ``lam2 < lam1``, ``theta2`` lies in

    K = Ball(c, R) ∩ {a^T (theta - theta1) >= 0} ∩ {y^T theta = 0}

    c = (1/lam2 + theta1) / 2,   R = || 1/lam2 - theta1 ||_2 / 2,
    a = (theta1 - 1/lam1) / || theta1 - 1/lam1 ||_2

and a feature with ``max_{theta in K} |fhat^T theta| < 1`` is safely
discarded (``fhat_j = y * X[j]``). The closed form of ``max_K v^T theta``
(:func:`_t_max`) needs four per-feature reductions over samples,

    d_theta_j = f_j . (y theta1),  d_one_j = f_j . y,
    d_y_j     = f_j . 1,           d_sq_j  = ||f_j||^2,

plus O(1) shared scalars (:class:`ScreenShared`). On the card the four
reductions and the finalizer are one kernel (``kernels/csrc/screen.cu``);
:func:`screen_bounds` dispatches there for CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = [
    "FeatureReductions",
    "ScreenShared",
    "feature_reductions",
    "row_dot",
    "shared_scalars",
    "shared_scalars_from_stats",
    "screen_bounds_from_reductions",
    "screen_bounds",
    "screen",
    "SAFE_TAU",
    "AnchorStats",
    "FixedStats",
    "anchor_stats",
    "fixed_stats",
    "shared_scalars_from_anchor",
    "finalize_from_anchor",
    "anchor_slice",
    "fixed_slice",
    "d_theta_sparse",
    "EDPPShared",
    "edpp_scalars",
    "edpp_scalars_from_stats",
    "edpp_scalars_from_anchor",
    "edpp_bounds_from_reductions",
]

# Keep a feature unless its bound is provably below 1; the tau margin absorbs
# floating-point accumulation error so rounding can never cause an unsafe
# rejection. The reference sized it from measurement: fp32 bound evaluation
# deviates from fp64 by up to ~2e-3 on adversarial instances.
SAFE_TAU = 1.0 - 2e-3

_EPS = 1e-30


class FeatureReductions(NamedTuple):
    """Per-feature sample-axis reductions (all shape ``(m,)``)."""

    d_theta: torch.Tensor  # fhat_j^T theta1 = f_j^T (y * theta1)
    d_one: torch.Tensor    # fhat_j^T 1     = f_j^T y
    d_y: torch.Tensor      # fhat_j^T y     = f_j^T 1
    d_sq: torch.Tensor     # ||fhat_j||^2   = ||f_j||^2


class ScreenShared(NamedTuple):
    """Feature-independent scalars (paper Sec. 6.4 'precompute & share'),
    each a 0-d tensor on the anchor's device."""

    inv_lam1: torch.Tensor
    inv_lam2: torch.Tensor
    yc: torch.Tensor          # y^T c
    ysq: torch.Tensor         # ||y||^2
    r_h_sq: torch.Tensor      # R_H^2 (ball radius^2 inside the hyperplane)
    g0: torch.Tensor          # a^T (c_H - theta1)
    qa_theta: torch.Tensor    # (Qa)^T (Q theta1)
    qa_sq: torch.Tensor       # ||Qa||^2
    a_norm: torch.Tensor      # ||theta1 - 1/lam1||
    a_dot_one: torch.Tensor   # a^T 1
    a_dot_y: torch.Tensor     # a^T y
    theta_dot_one: torch.Tensor
    theta_dot_y: torch.Tensor  # == 0 for an exactly feasible theta1
    halfspace_valid: torch.Tensor  # bool: ||theta1 - 1/lam1|| > 0


def row_dot(X: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``X @ v`` with fp32 accumulation (a plain GEMV)."""
    return torch.mv(X, v)


def feature_reductions(X: torch.Tensor, y: torch.Tensor,
                       theta1: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> FeatureReductions:
    """The four O(mn) reductions, batched over all features (plain version;
    the screen kernel computes them in one read of X).

    ``weights`` (n,) restricts the three theta-independent reductions to
    weighted samples, ``[f.(y s), f.s, f.(f s)]``: with a 0/1 live-sample
    mask they are the reference dynamic solver's ``bound_statics``.
    ``theta1`` is already zero off the live samples."""
    if weights is None:
        d = X @ torch.stack([y * theta1, y, torch.ones_like(y)], dim=1)
        d_sq = torch.sum(X * X, dim=1)
    else:
        d = X @ torch.stack([y * theta1, y * weights, weights], dim=1)
        d_sq = (X * X) @ weights
    return FeatureReductions(d_theta=d[:, 0], d_one=d[:, 1], d_y=d[:, 2],
                             d_sq=d_sq)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def shared_scalars(y: torch.Tensor, lam1, lam2, theta1: torch.Tensor,
                   delta=0.0) -> ScreenShared:
    """Scalars shared by every feature's bound (computed once, O(n)).

    ``delta`` upper-bounds ``||theta1 - theta1*||`` when theta1 is only
    approximately optimal; it inflates the ball and relaxes the halfspace so
    safety holds under inexact solves (see :func:`shared_scalars_from_stats`).
    """
    n = y.shape[0]
    return shared_scalars_from_stats(
        _scalar(lam1, theta1), _scalar(lam2, theta1),
        one_y=torch.sum(y),
        theta_dot_one=torch.sum(theta1),
        theta_dot_y=theta1 @ y,
        theta_sq=theta1 @ theta1,
        n_tot=_scalar(float(n), theta1),  # ||y||^2 = n for +-1 labels
        delta=_scalar(delta, theta1),
    )


def shared_scalars_from_stats(lam1, lam2, one_y, theta_dot_one, theta_dot_y,
                              theta_sq, n_tot, delta=0.0) -> ScreenShared:
    """:class:`ScreenShared` from global scalar statistics of ``(y, theta1)``:
    ``one_y = y^T 1``, ``theta_dot_one``, ``theta_dot_y``, ``theta_sq =
    ||theta1||^2`` and ``n_tot = ||y||^2``. Same arithmetic as the reference,
    including the inexact-theta ``delta`` inflation."""
    inv1, inv2 = 1.0 / lam1, 1.0 / lam2
    ysq = n_tot

    # ball: c = (inv2*1 + theta1)/2 ; R^2 = ||inv2*1 - theta1||^2 / 4
    yc = 0.5 * (inv2 * one_y + theta_dot_y)
    r_sq = 0.25 * (inv2 * inv2 * n_tot - 2.0 * inv2 * theta_dot_one + theta_sq)
    r_base = torch.sqrt(torch.clamp_min(r_sq, 0.0))
    r_infl = r_base + delta          # inexact-theta1 inflation (no-op at 0)
    r_h_sq = r_infl * r_infl - yc * yc / ysq

    # halfspace normal a = (theta1 - inv1*1)/||.||
    diff_sq = theta_sq - 2.0 * inv1 * theta_dot_one + inv1 * inv1 * n_tot
    a_norm = torch.sqrt(torch.clamp_min(diff_sq, 0.0))
    # relative validity: when theta1 == 1/lam1 analytically (balanced classes
    # at lam_max), a is pure rounding noise — compare against theta1's scale
    scale = torch.sqrt(theta_sq + inv1 * inv1 * n_tot)
    halfspace_valid = a_norm > 1e-6 * scale
    safe_norm = torch.clamp_min(a_norm, _EPS)
    a_dot_one = (theta_dot_one - inv1 * n_tot) / safe_norm
    a_dot_y = (theta_dot_y - inv1 * one_y) / safe_norm
    a_dot_theta = (theta_sq - inv1 * theta_dot_one) / safe_norm

    # c_H = c - (yc/ysq) y ;  g0 = a^T c_H - a^T theta1 (relaxed by delta slack)
    a_dot_c = 0.5 * (inv2 * a_dot_one + a_dot_theta)
    g0 = a_dot_c - (yc / ysq) * a_dot_y - a_dot_theta
    g0 = g0 + delta * (2.0 * r_base + 3.0 * delta + a_norm) / safe_norm
    qa_sq = torch.clamp_min(1.0 - a_dot_y * a_dot_y / ysq, 0.0)  # ||a|| = 1

    return ScreenShared(
        inv_lam1=inv1, inv_lam2=inv2, yc=yc, ysq=ysq, r_h_sq=r_h_sq, g0=g0,
        qa_theta=a_dot_theta - a_dot_y * theta_dot_y / ysq, qa_sq=qa_sq,
        a_norm=a_norm, a_dot_one=a_dot_one, a_dot_y=a_dot_y,
        theta_dot_one=theta_dot_one, theta_dot_y=theta_dot_y,
        halfspace_valid=halfspace_valid,
    )


def _t_max(v_ch, qv_qa, qv_sq, sh: ScreenShared) -> torch.Tensor:
    """``max_{theta in K} v^T theta`` from hyperplane-projected stats of v:
    ``v_ch = v^T c_H``, ``qv_qa = (Qv)^T (Qa)``, ``qv_sq = ||Qv||^2``.

    Case A (ball max satisfies the halfspace) or case B (sphere ∩ halfspace
    boundary). The halfspace is informative only when ``a`` has a component
    inside the hyperplane: at ``lam1 = lam_max`` with unbalanced classes
    ``a ∝ y``, ``||Qa|| = 0`` and both case conditions are 0/0 noise.
    ``torch.maximum`` propagates NaN, so a poisoned input gives a NaN bound
    (which :func:`screen` keeps).
    """
    zero = torch.zeros((), dtype=v_ch.dtype, device=v_ch.device)
    r_h = torch.sqrt(torch.maximum(sh.r_h_sq, zero))
    qv_norm = torch.sqrt(torch.maximum(qv_sq, zero))

    ball_val = v_ch + r_h * qv_norm
    at_ball = sh.g0 + r_h * qv_qa / torch.clamp_min(qv_norm, _EPS)
    halfspace_informative = sh.halfspace_valid & (sh.qa_sq > 1e-9)
    use_ball = (at_ball >= 0.0) | (~halfspace_informative) | (qv_norm <= _EPS)

    qa_sq = torch.clamp_min(sh.qa_sq, _EPS)
    mu = qv_qa / qa_sq
    vperp_sq = torch.maximum(qv_sq - mu * mu * qa_sq, zero)
    rho_sq = torch.maximum(sh.r_h_sq - sh.g0 * sh.g0 / qa_sq, zero)
    cut_val = v_ch - mu * sh.g0 + torch.sqrt(rho_sq) * torch.sqrt(vperp_sq)

    return torch.where(use_ball, ball_val, cut_val)


def screen_bounds_from_reductions(red: FeatureReductions,
                                  sh: ScreenShared) -> torch.Tensor:
    """Upper bound on ``|fhat_j^T theta2|`` per feature, from reductions only."""
    v_y = red.d_y
    v_c = 0.5 * (sh.inv_lam2 * red.d_one + red.d_theta)
    v_ch = v_c - (sh.yc / sh.ysq) * v_y
    qv_sq = red.d_sq - v_y * v_y / sh.ysq

    # (Qv)^T (Qa) = v^T a - (v^T y)(a^T y)/||y||^2
    safe_norm = torch.clamp_min(sh.a_norm, _EPS)
    v_a = (red.d_theta - sh.inv_lam1 * red.d_one) / safe_norm
    qv_qa = v_a - v_y * sh.a_dot_y / sh.ysq

    m_pos = _t_max(v_ch, qv_qa, qv_sq, sh)            # max  fhat^T theta
    m_neg = _t_max(-v_ch, -qv_qa, qv_sq, sh)          # max -fhat^T theta
    return torch.maximum(m_pos, m_neg)


class AnchorStats(NamedTuple):
    """A dual anchor ``theta1`` at ``lam`` as the scalars and the one
    reduction every rule program reads (the anchor half of a rule's region).
    The scalars are 0-d tensors on the anchor's device."""

    lam: torch.Tensor            # anchor regularization (lam1)
    delta: torch.Tensor          # ||theta1 - theta*(lam)|| inexactness radius
    theta_dot_one: torch.Tensor  # theta1^T 1
    theta_dot_y: torch.Tensor    # theta1^T y
    theta_sq: torch.Tensor       # ||theta1||^2
    d_theta: torch.Tensor        # (m,) fhat_j^T theta1 = f_j^T (y * theta1)


class FixedStats(NamedTuple):
    """Theta-independent statics shared by every anchor and every rule (the
    fixed half of the region; computed once per path)."""

    d_one: torch.Tensor   # (m,) fhat_j^T 1
    d_y: torch.Tensor     # (m,) fhat_j^T y
    d_sq: torch.Tensor    # (m,) ||fhat_j||^2
    one_y: torch.Tensor   # y^T 1
    n_tot: torch.Tensor   # ||y||^2 = #live samples


def anchor_stats(y: torch.Tensor, lam, theta1: torch.Tensor, delta,
                 d_theta: torch.Tensor) -> AnchorStats:
    """:class:`AnchorStats` of an in-core anchor; the caller supplies the one
    O(mn) reduction ``d_theta``. The scalars are those :func:`shared_scalars`
    computes, so both entries give the same :class:`ScreenShared` bits."""
    return AnchorStats(lam=_scalar(lam, theta1), delta=_scalar(delta, theta1),
                       theta_dot_one=torch.sum(theta1), theta_dot_y=theta1 @ y,
                       theta_sq=theta1 @ theta1, d_theta=d_theta)


def fixed_stats(y: torch.Tensor, d_one: torch.Tensor, d_y: torch.Tensor,
                d_sq: torch.Tensor) -> FixedStats:
    """:class:`FixedStats` from an in-core ``y`` and the three
    theta-independent reductions."""
    return FixedStats(d_one=d_one, d_y=d_y, d_sq=d_sq, one_y=torch.sum(y),
                      n_tot=_scalar(float(y.shape[0]), y))


def shared_scalars_from_anchor(anchor: AnchorStats, lam2,
                               fixed: FixedStats) -> ScreenShared:
    """:class:`ScreenShared` of the VI set anchored at ``anchor``, targeting
    ``lam2`` (converted to the anchor's dtype, as :func:`shared_scalars`
    does)."""
    return shared_scalars_from_stats(
        anchor.lam, _scalar(lam2, anchor.theta_sq), one_y=fixed.one_y,
        theta_dot_one=anchor.theta_dot_one, theta_dot_y=anchor.theta_dot_y,
        theta_sq=anchor.theta_sq, n_tot=fixed.n_tot, delta=anchor.delta)


def finalize_from_anchor(anchor: AnchorStats, lam2,
                         fixed: FixedStats) -> torch.Tensor:
    """The VI bound over the region: per-feature upper bounds on
    ``|fhat_j^T theta*(lam2)|`` from one anchor's stats."""
    sh = shared_scalars_from_anchor(anchor, lam2, fixed)
    red = FeatureReductions(d_theta=anchor.d_theta, d_one=fixed.d_one,
                            d_y=fixed.d_y, d_sq=fixed.d_sq)
    return screen_bounds_from_reductions(red, sh)


def anchor_slice(anchor: AnchorStats, lo: int, hi: int) -> AnchorStats:
    """Restrict an anchor's per-feature reduction to rows ``[lo, hi)``; the
    scalars are feature-independent and pass through (the region one chunk
    of feature rows reads)."""
    return anchor._replace(d_theta=anchor.d_theta[lo:hi])


def fixed_slice(fixed: FixedStats, lo: int, hi: int) -> FixedStats:
    """Restrict the fixed statics to feature rows ``[lo, hi)``."""
    return fixed._replace(d_one=fixed.d_one[lo:hi], d_y=fixed.d_y[lo:hi],
                          d_sq=fixed.d_sq[lo:hi])


def d_theta_sparse(X: torch.Tensor, y: torch.Tensor, theta1: torch.Tensor,
                   support: int) -> torch.Tensor:
    """``fhat_j^T theta1`` over the ``support`` largest ``|theta1_i|`` only
    (paper Sec. 6.4): theta1 is nonzero on the support vectors alone, so
    with ``support >= nnz(theta1)`` the product over those columns is the
    whole one, at O(m * support). Entries past nnz are zeros and add 0."""
    support = min(int(support), theta1.shape[0])
    _, idx = torch.topk(torch.abs(theta1), support)
    return X[:, idx] @ (y * theta1)[idx]


class EDPPShared(NamedTuple):
    """Feature-independent scalars of the EDPP projection ball on the
    hyperplane (``core/rules/programs.py``), 0-d tensors on the anchor's
    device. With :class:`ScreenShared`'s ``inv_lam1``, ``inv_lam2`` and
    ``ysq`` they are all the per-feature EDPP bound reads."""

    mu: torch.Tensor      # <v1, v2> / ||v1||^2, 0 when v1 is degenerate
    yc: torch.Tensor      # y^T (ball center)
    r_h_sq: torch.Tensor  # delta-inflated radius^2 inside the hyperplane


def edpp_scalars_from_stats(lam1, lam2, one_y, theta_dot_one, theta_dot_y,
                            theta_sq, n_tot, delta) -> EDPPShared:
    """:class:`EDPPShared` from the anchor's global scalars (the arguments
    of :func:`shared_scalars_from_stats`, 0-d tensors of one dtype).

    With ``o_k = (1/lam_k) 1``, ``v1 = o1 - theta1`` lies in the normal cone
    at ``theta1`` and ``theta2`` lies in the ball of center ``theta1 +
    v2perp/2`` and radius ``||v2perp||/2``, ``v2 = o2 - theta1``, ``v2perp =
    v2 - mu v1``. An inexact anchor inflates the radius by ``2 delta + 2
    delta (||v2|| + delta) / max(||v1|| - delta, eps)``; a ``v1`` at noise
    scale (balanced classes at ``lam_max``, or ``||v1|| ~ delta``) falls
    back to ``mu = 0``, the DPP ball, with the plain ``delta`` inflation.
    Same arithmetic as the reference's ``_edpp_bounds``."""
    inv1 = 1.0 / lam1
    inv2 = 1.0 / lam2
    v1_sq = theta_sq - 2.0 * inv1 * theta_dot_one + inv1 * inv1 * n_tot
    v2_sq = theta_sq - 2.0 * inv2 * theta_dot_one + inv2 * inv2 * n_tot
    v1v2 = inv1 * inv2 * n_tot - (inv1 + inv2) * theta_dot_one + theta_sq
    v1_norm = torch.sqrt(torch.clamp_min(v1_sq, 0.0))
    v2_norm = torch.sqrt(torch.clamp_min(v2_sq, 0.0))

    scale = torch.sqrt(theta_sq + inv1 * inv1 * n_tot)
    degenerate = v1_norm <= torch.maximum(10.0 * delta, 1e-6 * scale)
    zero = torch.zeros_like(v1_sq)
    mu = torch.where(degenerate, zero, v1v2 / torch.clamp_min(v1_sq, _EPS))

    vperp_sq = torch.clamp_min(v2_sq - 2.0 * mu * v1v2 + mu * mu * v1_sq, 0.0)
    r = 0.5 * torch.sqrt(vperp_sq)
    infl = torch.where(
        degenerate, delta,
        2.0 * delta + 2.0 * delta * (v2_norm + delta)
        / torch.clamp_min(v1_norm - delta, _EPS))
    r_infl = r + infl

    y_v1 = inv1 * one_y - theta_dot_y
    y_v2 = inv2 * one_y - theta_dot_y
    yc = theta_dot_y + 0.5 * (y_v2 - mu * y_v1)
    return EDPPShared(mu=mu, yc=yc, r_h_sq=r_infl * r_infl - yc * yc / n_tot)


def edpp_scalars(y: torch.Tensor, lam1, lam2, theta1: torch.Tensor,
                 delta=0.0) -> EDPPShared:
    """:class:`EDPPShared` of an in-core anchor, in ``theta1``'s dtype and on
    its device (the scalars of :func:`shared_scalars`)."""
    return edpp_scalars_from_stats(
        _scalar(lam1, theta1), _scalar(lam2, theta1), one_y=torch.sum(y),
        theta_dot_one=torch.sum(theta1), theta_dot_y=theta1 @ y,
        theta_sq=theta1 @ theta1, n_tot=_scalar(float(y.shape[0]), theta1),
        delta=_scalar(delta, theta1))


def edpp_scalars_from_anchor(anchor: AnchorStats, lam2,
                             fixed: FixedStats) -> EDPPShared:
    """:class:`EDPPShared` of the region anchored at ``anchor``, targeting
    ``lam2`` (converted to the anchor's dtype)."""
    return edpp_scalars_from_stats(
        anchor.lam, _scalar(lam2, anchor.theta_sq), one_y=fixed.one_y,
        theta_dot_one=anchor.theta_dot_one, theta_dot_y=anchor.theta_dot_y,
        theta_sq=anchor.theta_sq, n_tot=fixed.n_tot, delta=anchor.delta)


def edpp_bounds_from_reductions(red: FeatureReductions, sh: ScreenShared,
                                e: EDPPShared) -> torch.Tensor:
    """The EDPP ball on the hyperplane ``y^T theta = 0``, min-composed with
    the VI bound of the same anchor (``sh``): per-feature upper bounds on
    ``|fhat_j^T theta2|``. Both regions contain ``theta2``, so the min is a
    valid bound, and it is never above the VI bound: EDPP keeps are a
    subset of VI keeps. ``torch.minimum`` propagates NaN."""
    v_v1 = sh.inv_lam1 * red.d_one - red.d_theta
    v_v2 = sh.inv_lam2 * red.d_one - red.d_theta
    v_c = red.d_theta + 0.5 * (v_v2 - e.mu * v_v1)     # fhat^T center
    v_ch = v_c - (e.yc / sh.ysq) * red.d_y
    qv_sq = torch.clamp_min(red.d_sq - red.d_y * red.d_y / sh.ysq, 0.0)
    zero = torch.zeros_like(e.r_h_sq)
    ball = (torch.abs(v_ch)
            + torch.sqrt(torch.maximum(e.r_h_sq, zero)) * torch.sqrt(qv_sq))
    return torch.minimum(ball, screen_bounds_from_reductions(red, sh))


def screen_bounds(X: torch.Tensor, y: torch.Tensor, lam1, lam2,
                  theta1: torch.Tensor, delta=0.0) -> torch.Tensor:
    """Upper bound on ``|fhat_j^T theta*(lam2)|`` for every feature j.

    The sweep goes through the kernel seam (``kernels/ops.py``): the CUDA
    screen kernel for a CUDA ``X``, its plain version for a CPU one.
    """
    sh = shared_scalars(y, lam1, lam2, theta1, delta=delta)
    from ..kernels.ops import screen_bounds_from_shared  # lazy: no import cycle

    return screen_bounds_from_shared(X, y, theta1, sh)


def screen(X: torch.Tensor, y: torch.Tensor, lam1, lam2, theta1: torch.Tensor,
           tau: float = SAFE_TAU, delta=0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Safe screening (paper Algorithm 1), batched over all m features.

    Returns ``(keep_mask, bounds)``. The comparison is NaN-safe in the keep
    direction: a non-finite bound certifies nothing, so the feature is kept.
    """
    bounds = screen_bounds(X, y, lam1, lam2, theta1, delta=delta)
    return ~(bounds < tau), bounds
