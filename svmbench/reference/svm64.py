"""Plain float64 reference for the L1-regularized squared-hinge SVM path.

The problem at ``lam`` over ``X (m features, n samples)`` and ``y in
{-1, +1}^n`` (the paper's Eq. 1):

    P(w, b) = 1/2 sum_i xi_i^2 + lam ||w||_1,
    xi_i = max(0, 1 - y_i (x_i^T w + b)).

Its optimality conditions, with ``g = X (y * xi)`` (minus the loss's
gradient in w): ``g_j = lam sign(w_j)`` where ``w_j != 0``, ``|g_j| <= lam``
where ``w_j = 0``, and ``y^T xi = 0`` (the bias). ``lambda_max = ||X (y -
mean(y))||_inf`` is the smallest ``lam`` at which ``w = 0``.

:func:`judge` takes a path that a solver reports (weights, biases and
objectives at each ``lam``, the features and samples each step's solve was
fed, each step's certified radius) and works out, in float64 from ``X`` and
``y`` alone, how far each step is from these conditions:

* ``obj_rel``: the reported objective against ``P(w, b)`` on the whole
  problem (a sample screened out with slack, or an objective taken on other
  data, shows here);
* ``kkt_rel``: the largest violation of the conditions over every feature,
  screened ones too, and the bias, over ``lam``;
* ``gap_rel``: ``(P - D) / P`` for the certificate's dual point, built
  from the slacks by ``FEAS_ROUNDS`` rounds of a scale into ``|X (y
  alpha)| <= lam`` and a projection onto ``y^T alpha = 0`` clipped at 0;
* ``screen_ratio``: ``max |g_j| / lam`` over the features the screen
  discarded (above 1: one of them violates its condition; 0 where none
  was discarded);
* ``sample_slack``: the largest slack of a sample the screen discarded;
* ``cert_factor``: how many times the radius this dual point certifies in
  float64, ``(sqrt(2 gap) + 2 |y^T alpha| / sqrt(n)) / lam``, exceeds the
  radius the solver certified (at most 1 where the solver's covers it; 0
  where it certified a radius of 0 for ``w = 0``, the exact closed form at
  ``lambda_max``, and infinite where it did so for any other ``w``).

Every product with X runs in blocks of rows cast to float64, so the
reference holds one block in float64 at a time. It uses nothing but
``torch`` and ``numpy``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: elements of X cast to float64 at a time (1 GiB)
BLOCK_ELEMENTS = 2 ** 27
#: rounds of the certificate's feasibility projection (the paper's
#: ``safe_theta_and_delta`` and the port's engines take 8)
FEAS_ROUNDS = 8


def _blocks(m: int, n: int):
    rows = max(1, BLOCK_ELEMENTS // max(n, 1))
    for r0 in range(0, m, rows):
        yield r0, min(m, r0 + rows)


def xt_times(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``X^T W`` in float64 (``W`` (m, k) float64), reading only the rows
    where ``W`` has a nonzero."""
    m, n = X.shape
    rows = torch.nonzero(torch.any(W != 0, dim=1)).flatten()
    out = torch.zeros((n, W.shape[1]), dtype=torch.float64, device=X.device)
    for r0, r1 in _blocks(rows.numel(), n):
        idx = rows[r0:r1]
        out += X.index_select(0, idx).to(torch.float64).t() @ W.index_select(0, idx)
    return out


def x_times(X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``X V`` in float64 (``V`` (n, k) float64)."""
    m, n = X.shape
    out = torch.empty((m, V.shape[1]), dtype=torch.float64, device=X.device)
    for r0, r1 in _blocks(m, n):
        out[r0:r1] = X[r0:r1].to(torch.float64) @ V
    return out


def judge(X: torch.Tensor, y: torch.Tensor, path: dict) -> dict:
    """Per-step float64 readings of ``path`` on ``(X, y)``, and
    ``lam_max_rel``. ``path`` holds numpy arrays: ``lambdas`` (T,),
    ``weights`` (T, m), ``biases`` (T,), ``objectives`` (T,), ``keep_masks``
    (T, m) bool (the features fed to each step's solve), ``sample_masks``
    ({step: (n,) bool}, the samples fed to it), ``deltas`` (T,) and
    ``lam_max``. Returns numpy arrays (T,) under the names of the module
    docstring; ``lam_max_rel`` is a float."""
    dev = X.device
    f64 = dict(dtype=torch.float64, device=dev)
    lam = torch.as_tensor(path["lambdas"], **f64)
    W = torch.as_tensor(np.asarray(path["weights"]).T, **f64).contiguous()  # (m, T)
    b = torch.as_tensor(path["biases"], **f64)
    y64 = y.to(torch.float64)
    T = lam.numel()

    xi = torch.clamp_min(1.0 - y64[:, None] * (xt_times(X, W) + b[None, :]), 0.0)
    primal = 0.5 * torch.sum(xi * xi, 0) + lam * torch.sum(torch.abs(W), 0)
    # the first product gives the optimality conditions' g, the first
    # feasibility scale of the dual point and lambda_max
    G = x_times(X, torch.cat([y64[:, None] * xi, (y64 - y64.mean())[:, None]], dim=1))
    g = G[:, :T]
    lam_max = float(torch.max(torch.abs(G[:, T])))

    # the certificate's dual point from the slacks: FEAS_ROUNDS rounds of a
    # scale into |X (y alpha)| <= lam and the projection onto y^T alpha = 0
    # clipped at 0, then the scale once more
    n = y64.numel()

    def scale(corr):
        return torch.clamp_max(
            lam / torch.clamp_min(torch.max(torch.abs(corr), 0).values, 1e-300), 1.0)

    alpha, corr = xi, g
    for _ in range(FEAS_ROUNDS):
        alpha = alpha * scale(corr)[None, :]
        alpha = torch.clamp_min(alpha - (y64 @ alpha)[None, :] / n * y64[:, None], 0.0)
        corr = x_times(X, y64[:, None] * alpha)
    alpha = alpha * scale(corr)[None, :]
    dual = torch.sum(alpha, 0) - 0.5 * torch.sum(alpha * alpha, 0)
    gap = primal - dual
    eq_resid = torch.abs(y64 @ alpha) / math.sqrt(n)
    radius = (torch.sqrt(2.0 * torch.clamp_min(gap, 0.0)) + 2.0 * eq_resid) / lam

    nz = W != 0
    resid = torch.where(nz, torch.abs(g - lam[None, :] * torch.sign(W)),
                        torch.clamp_min(torch.abs(g) - lam[None, :], 0.0))
    bias_resid = torch.abs(torch.sum(y64[:, None] * xi, 0))
    kkt = torch.maximum(torch.max(resid, 0).values, bias_resid) / lam

    dropped = ~torch.as_tensor(np.asarray(path["keep_masks"]).T, device=dev)
    dropped[:, 0] = False  # step 0 is solved or closed-form, never screened
    screen_ratio = torch.max(torch.where(dropped, torch.abs(g) / lam[None, :], 0.0),
                             0).values

    slack = np.zeros((T,))
    xi_h = None
    for k, kept in path.get("sample_masks", {}).items():
        if not np.all(kept):
            if xi_h is None:
                xi_h = xi.cpu().numpy()
            slack[k] = float(np.max(xi_h[~np.asarray(kept), k]))

    deltas = torch.as_tensor(np.asarray(path["deltas"], np.float64), **f64)
    obj = torch.as_tensor(np.asarray(path["objectives"], np.float64), **f64)
    h = lambda t: t.cpu().numpy()  # noqa: E731
    return {
        "lam_max_rel": abs(float(path["lam_max"]) - lam_max) / lam_max,
        "obj_rel": h(torch.abs(obj - primal) / primal),
        "kkt_rel": h(kkt),
        "gap_rel": h(gap / primal),
        "screen_ratio": h(screen_ratio),
        "sample_slack": slack,
        "cert_factor": h(torch.where((deltas > 0) | torch.any(nz, 0),
                                     radius / deltas, 0.0)),
    }


def _kkt_rel(X, y, w, b, lam) -> float:
    xi = torch.clamp_min(1.0 - y * (X.t() @ w + b), 0.0)
    g = X @ (y * xi)
    resid = torch.where(w != 0, torch.abs(g - lam * torch.sign(w)),
                        torch.clamp_min(torch.abs(g) - lam, 0.0))
    return float(torch.maximum(torch.max(resid), torch.abs(y @ xi)) / lam)


def solve_path(X, y, lambdas, tol: float = 1e-9, max_iters: int = 200_000) -> dict:
    """A plain float64 path: at each ``lam``, warm-started proximal
    gradient with momentum (FISTA, restarted when the objective rises) on
    the whole problem, until ``kkt_rel <= tol``. For instances small enough
    to hold ``X`` in float64; the judge above needs no solve."""
    X = X.to(torch.float64)
    y = y.to(torch.float64)
    m, n = X.shape
    A = torch.cat([X, torch.ones((1, n), dtype=X.dtype, device=X.device)])
    v = torch.ones((n,), dtype=X.dtype, device=X.device)
    for _ in range(500):  # power iteration for sigma_max([X; 1])^2
        v = A.t() @ (A @ v)
        v = v / torch.linalg.vector_norm(v)
    step = 1.0 / (1.01 * float(torch.linalg.vector_norm(A.t() @ (A @ v))))

    def parts(z, lam):
        xi = torch.clamp_min(1.0 - y * (A.t() @ z), 0.0)
        return 0.5 * float(xi @ xi) + lam * float(torch.sum(torch.abs(z[:m]))), \
            -(A @ (y * xi))

    z = torch.zeros((m + 1,), dtype=X.dtype, device=X.device)
    z[m] = torch.mean(y)
    W, B, obj = [], [], []
    for lam in np.asarray(lambdas, np.float64):
        zp, t, f_prev = z.clone(), 1.0, math.inf
        for it in range(max_iters):
            t_next = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
            u = z + ((t - 1.0) / t_next) * (z - zp)
            _, grad = parts(u, lam)
            nz = u - step * grad
            nz[:m] = torch.sign(nz[:m]) * torch.clamp_min(torch.abs(nz[:m]) - step * lam, 0.0)
            f, _ = parts(nz, lam)
            zp, z, t = z, nz, t_next
            if f > f_prev:  # restart the momentum
                t = 1.0
            f_prev = f
            if it % 25 == 0 and _kkt_rel(X, y, z[:m], z[m], lam) <= tol:
                break
        W.append(z[:m].clone())
        B.append(float(z[m]))
        obj.append(parts(z, lam)[0])
    return {"weights": torch.stack(W).cpu().numpy(), "biases": np.asarray(B),
            "objectives": np.asarray(obj)}
