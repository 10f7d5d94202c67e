"""The paper's closed forms (Theorems 6.5/6.7/6.9, Algorithm 1) implemented
*literally*, as an independent cross-check of core/screening.py.

Our production implementation derives the bound geometrically (hyperplane
projection first); this module follows the paper's own algebra:

    neg_min(fhat) = -min_{theta in K} theta^T fhat          (Algorithm 1)
    bound          = max(neg_min(fhat), neg_min(-fhat))

Cases (paper numbering):
  * Cor. 6.8  (beta>0, alpha=0): ball-interior solution,
        neg_min = ||P_y(b)|| ||P_y(f)|| - P_y(b)^T P_y(f) - f^T theta1
  * Cor. 6.10 (beta>0, alpha>0): sphere∩plane via the Thm-6.2 minimal ball,
        neg_min = 1/2 (1/l2 - 1/l1) (||u_f|| ||u_1|| - u_1^T u_f) - f^T theta1
        with u_x = P_{P_a(y)}(P_a(x))
  * Thm. 6.5  (beta=0): colinear degenerate case — measure-zero in floats;
    handled by the tolerance in the case-selection condition.

Sign convention: the paper's Eq. (43) writes the halfspace as
``a^T(b+r) <= 0`` although the variational inequality (Eq. 31) it comes from
gives ``a^T(theta2-theta1) >= 0`` with b + r = theta2 - theta1. The
case-selection condition below uses the VI-consistent orientation (matching
our geometric implementation and verified empirically by
tests/test_paper_reference.py: the two independent implementations agree to
fp tolerance on random instances, and safety holds).

This module is intentionally NOT vectorized (feature-at-a-time, like the
paper's Algorithm 1) — it is a reference, not a fast path.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def _proj_out(v: np.ndarray, u: np.ndarray) -> np.ndarray:
    """P_u(v): project v onto the null space of u (paper Eq. 39)."""
    uu = float(u @ u)
    if uu < _EPS:
        return v.copy()
    return v - (float(v @ u) / uu) * u


def neg_min(fhat: np.ndarray, y: np.ndarray, lam1: float, lam2: float,
            theta1: np.ndarray) -> float:
    """-min_{theta in K} theta^T fhat, paper Algorithm 1 lines 12-23."""
    n = len(y)
    ones = np.ones(n)
    a_raw = theta1 - ones / lam1
    a_norm = float(np.linalg.norm(a_raw))
    b = 0.5 * (ones / lam2 - theta1)

    py_f = _proj_out(fhat, y)
    py_b = _proj_out(b, y)

    scale = float(np.sqrt(theta1 @ theta1 + n / lam1 ** 2))
    if a_norm < 1e-6 * scale:
        # no halfspace information (theta1 == 1/lam1 up to rounding — e.g.
        # balanced classes at lam_max): ball ∩ hyperplane only
        return float(np.linalg.norm(py_b) * np.linalg.norm(py_f)
                     - py_b @ py_f - fhat @ theta1)

    a = a_raw / a_norm
    py_a = _proj_out(a, y)

    if float(py_a @ py_a) < 1e-9:
        # a ∝ y: the halfspace is vacuous inside {y^T theta = 0} (happens
        # exactly at lam1 = lam_max with unbalanced classes) — ball-only.
        return float(np.linalg.norm(py_b) * np.linalg.norm(py_f)
                     - py_b @ py_f - fhat @ theta1)

    # Thm 6.5 colinearity (beta = 0) — degenerate, fold into the tolerance of
    # the halfspace condition below (cos == -1 lands in the alpha=0 branch).

    # Algorithm 1 line 17 condition. Orientation note: the paper's Eq. (43)
    # writes the halfspace with its own sign convention (see module
    # docstring); transcribing the condition with a_VI = (theta1 - 1/lam1)
    # mis-selects cases (verified against an SLSQP ground-truth maximizer:
    # the VI orientation sent ball-max instances into the Cor-6.10 branch,
    # 3x loose). The paper's convention corresponds to -a_VI here:
    nb = max(float(np.linalg.norm(py_b)), _EPS)
    nf = max(float(np.linalg.norm(py_f)), _EPS)
    cond = float(-py_a @ (py_b / nb - py_f / nf))
    if cond <= 0.0:
        # Cor. 6.8: beta > 0, alpha = 0
        return float(nb * nf - py_b @ py_f - fhat @ theta1)

    # Cor. 6.10: beta > 0, alpha > 0 — switch to the Thm-6.2 minimal ball
    pa_y = _proj_out(y, a)
    pa_f = _proj_out(fhat, a)
    pa_1 = _proj_out(ones, a)
    u_f = _proj_out(pa_f, pa_y)
    u_1 = _proj_out(pa_1, pa_y)
    factor = 0.5 * (1.0 / lam2 - 1.0 / lam1)
    return float(factor * (np.linalg.norm(u_f) * np.linalg.norm(u_1) - u_1 @ u_f)
                 - fhat @ theta1)


def screen_bounds_paper(X: np.ndarray, y: np.ndarray, lam1: float,
                        lam2: float, theta1: np.ndarray) -> np.ndarray:
    """Per-feature bound on |fhat^T theta2| via the paper's Algorithm 1."""
    m = X.shape[0]
    out = np.zeros(m)
    for j in range(m):
        fhat = y * X[j]
        out[j] = max(neg_min(fhat, y, lam1, lam2, theta1),
                     neg_min(-fhat, y, lam1, lam2, theta1))
    return out
