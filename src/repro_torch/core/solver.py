"""FISTA for the L1-regularized L2-loss SVM (paper Eq. 1/23).

Port of the reference ``core/solver.py`` (single device). Composite form

    min_{w,b}  h(w, b) + lam ||w||_1,
    h(w, b) = 1/2 sum_i max(0, 1 - y_i (w^T x_i + b))^2

with gradients ``grad_w = -X (y * xi)``, ``grad_b = -y^T xi`` and Lipschitz
bound ``L <= sigma_max([X; 1^T])^2``. Removing rows or columns never raises
``sigma_max``, so a path estimates L once on the full X and every reduced
solve reuses it.

The fused body pays two sweeps of X per iteration: the state carries
``u = X^T w`` and ``u_prev``, so the momentum point's margins are an O(n)
axpy; the gradient sweep (``kernels/hinge.py`` ``hinge_grad_op``) and the
fused margin/loss sweep at the new iterate (``margin_obj_op``) are the two
passes. On a CUDA X both are the hand-written kernels.

The reference's ``lax.while_loop`` / ``lax.cond`` become host control flow
over device tensors. Each iteration fetches one small tensor (the candidate
objective and a finiteness flag) to decide the monotone restart, the health
guard and the stop rule; the restart pays its two sweeps only when it fires
(and one more fetch). Scalars the reference carries in fp32 (``t``, the
objective history, the step backoff) are kept as numpy float32 on the host,
so the decisions are taken in the same precision.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.ops import hinge_grad_op, margin_obj_op

__all__ = [
    "FistaState",
    "FistaResult",
    "MAX_GUARD_TRIPS",
    "HEALTH_SCREEN_REFUSED",
    "lipschitz_estimate",
    "soft_threshold",
    "fista_solve",
]

#: Cap on health-guard rollbacks per solve. Each trip halves the step size;
#: a solve still tripping after 8 is unrecoverable (poisoned operands).
MAX_GUARD_TRIPS = 8

#: Bit set in a path step's ``health`` when its screen was refused because
#: the previous certificate was non-finite. Low bits count guard trips.
HEALTH_SCREEN_REFUSED = 1 << 16

_F32 = np.float32
_EPS32 = np.finfo(np.float32).eps


class FistaState(NamedTuple):
    """One FISTA iterate: device tensors and host fp32 scalars."""

    w: torch.Tensor
    b: torch.Tensor       # 0-d
    w_prev: torch.Tensor
    b_prev: torch.Tensor
    u: torch.Tensor       # X^T w      (margins of the current point, no bias)
    u_prev: torch.Tensor  # X^T w_prev
    t: np.float32
    k: int
    obj: np.float32
    # convergence needs THREE consecutive sub-tol iterations: in fp32 a
    # single rel_change below the objective's ulp is a tie on a momentum
    # plateau, not evidence of the optimum (reference FistaState.rel_prev)
    rel_change: np.float32
    rel_prev: np.float32
    rel_prev2: np.float32
    health: int           # guard trips (rollbacks + sanitized warm start)
    backoff: np.float32   # step-size factor the trips applied

    def rel3(self) -> np.float32:
        """Worst rel_change of the last three iterations (the stop rule)."""
        return max(self.rel_change, self.rel_prev, self.rel_prev2)


class FistaResult(NamedTuple):
    w: torch.Tensor
    b: torch.Tensor   # 0-d, on X's device
    obj: float
    n_iters: int
    converged: bool
    u: torch.Tensor   # X^T w at the accepted point
    health: int       # guard trips (0 = clean solve)


def soft_threshold(x: torch.Tensor, tau) -> torch.Tensor:
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - tau, 0.0)


def lipschitz_estimate(X: torch.Tensor, n_iters: int = 100,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Power iteration for ``sigma_max([X; 1^T])^2`` (augmented bias row).

    100 iterations, not the reference's 30: on the 2000 x 400 bench instance
    (seed 0) 30 iterations stop 3.5% below the true value, which makes the
    step ``1 / (1.01 L)`` too long; 100 stay within 0.1%, and cost two GEMVs
    each, once per path. The start vector is standard normal from
    ``generator`` (default: a CPU generator seeded 0, so CPU and CUDA runs
    start alike). Returns a 0-d tensor on X's device; it never exceeds the
    true value beyond rounding.
    """
    n = X.shape[1]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v = torch.randn(n, generator=generator, device=generator.device,
                    dtype=X.dtype).to(X.device)
    for _ in range(n_iters):
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-30)
        u_w = torch.mv(X, v)
        v = torch.mv(X.t(), u_w) + torch.sum(v)
    return torch.linalg.vector_norm(v)  # ||A^T A v|| with ||v|| = 1


def _margin_obj_sweep(X, y, lam, w, b, sm, valid_m):
    """One fused pass over X: ``(u = X^T w, objective(w, b))``. With a sample
    mask the O(n) masked loss is recomputed from the returned slacks."""
    u, xi, loss = margin_obj_op(X, w, y, b, valid_m)
    if sm is not None:
        xi = xi * sm
        loss = 0.5 * torch.sum(xi * xi)
    return u, loss + lam * torch.sum(torch.abs(w))


def _fetch(obj: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The one host sync of an iteration: ``(objective, all finite)``."""
    finite = torch.isfinite(w).all() & torch.isfinite(b)
    obj_h, fin_h = torch.stack([obj, finite.to(obj.dtype)]).tolist()
    obj_h = _F32(obj_h)
    return obj_h, bool(fin_h) and bool(np.isfinite(obj_h))


def fista_solve(
    X: torch.Tensor,
    y: torch.Tensor,
    lam,
    w0: Optional[torch.Tensor] = None,
    b0=None,
    max_iters: int = 2000,
    tol: float = 1e-9,
    L=None,
    sample_mask: Optional[torch.Tensor] = None,
    valid_m: Optional[int] = None,
) -> FistaResult:
    """Solve the primal to relative-objective tolerance ``tol``.

    ``X`` (m, n) features x samples on its device; warm starts via
    ``w0``/``b0``. ``L`` is a known upper bound on the Lipschitz constant
    (path drivers pass the full-X estimate), else it is estimated here; the
    step is ``1 / (1.01 L)``. ``sample_mask`` (0/1 over samples) drops
    columns from the loss. ``valid_m`` marks the live leading rows of a
    zero-padded gather buffer: the sweeps skip the rest.

    The health guard is always on: a poisoned warm start is zeroed (one
    trip), and a non-finite candidate or a restart step that still raised
    the objective rolls back to the last accepted point, halves the step and
    counts a trip; the solve stops after :data:`MAX_GUARD_TRIPS` trips.
    """
    m = X.shape[0]
    dev, dtype = X.device, X.dtype
    lam = _F32(float(lam))
    if w0 is None:
        w0 = torch.zeros((m,), dtype=dtype, device=dev)
    if b0 is None:
        b0 = torch.mean(y)
    b0 = torch.as_tensor(b0, dtype=dtype, device=dev).reshape(())
    if L is None:
        L = lipschitz_estimate(X)
    L = max(_F32(float(L)) * _F32(1.01), _F32(1e-12))  # small safety factor
    inv_L = _F32(1.0) / L
    tol = _F32(tol)

    # sanitize the warm start: w = 0 is always feasible
    bad0 = ~(torch.isfinite(w0).all() & torch.isfinite(b0))
    w0 = torch.where(torch.isfinite(w0), w0, torch.zeros_like(w0))
    b0 = torch.where(torch.isfinite(b0), b0, torch.zeros_like(b0))
    u0, obj0 = _margin_obj_sweep(X, y, float(lam), w0, b0, sample_mask, valid_m)
    obj0_h, bad0_h = torch.stack([obj0, bad0.to(obj0.dtype)]).tolist()
    inf = _F32(np.inf)
    s = FistaState(w=w0, b=b0, w_prev=w0, b_prev=b0, u=u0, u_prev=u0,
                   t=_F32(1.0), k=0, obj=_F32(obj0_h), rel_change=inf,
                   rel_prev=inf, rel_prev2=inf, health=int(bad0_h > 0.5),
                   backoff=_F32(1.0))

    def prox_from(w_a, b_a, u_a, inv_Le):
        """One proximal-gradient step from ``(w_a, b_a)`` whose margins
        ``u_a = X^T w_a`` are known. Two sweeps of X."""
        xi = torch.clamp_min(1.0 - y * (u_a + b_a), 0.0)
        if sample_mask is not None:
            xi = xi * sample_mask
        gw = hinge_grad_op(X, y, xi, valid_m)
        gb = -torch.sum(y * xi)
        w_new = soft_threshold(w_a - float(inv_Le) * gw, float(lam * inv_Le))
        b_new = b_a - float(inv_Le) * gb
        u_new, obj_new = _margin_obj_sweep(X, y, float(lam), w_new, b_new,
                                           sample_mask, valid_m)
        return w_new, b_new, u_new, obj_new

    with np.errstate(all="ignore"):
        while s.k < max_iters and s.rel3() > tol and s.health < MAX_GUARD_TRIPS:
            inv_Le = inv_L * s.backoff
            t_next = _F32(0.5) * (_F32(1.0)
                                  + np.sqrt(_F32(1.0) + _F32(4.0) * s.t * s.t))
            beta = float((s.t - _F32(1.0)) / t_next)
            zw = s.w + beta * (s.w - s.w_prev)
            zb = s.b + beta * (s.b - s.b_prev)
            uz = s.u + beta * (s.u - s.u_prev)
            w_c, b_c, u_c, obj_d = prox_from(zw, zb, uz, inv_Le)
            obj_c, finite = _fetch(obj_d, w_c, b_c)

            # monotone restart: the extrapolated step raised the objective,
            # so take a plain proximal step from (w, b) instead (a NaN
            # objective compares False and falls through to the guard)
            restarted = bool(obj_c > s.obj)
            if restarted:
                w_c, b_c, u_c, obj_d = prox_from(s.w, s.b, s.u, inv_Le)
                obj_c, finite = _fetch(obj_d, w_c, b_c)
                t_next = _F32(1.0)
            # a restart iteration is not convergence evidence
            rel = inf if restarted else (
                abs(s.obj - obj_c) / max(abs(s.obj), _F32(1e-30)))

            # guard: a non-finite candidate, or a plain step (valid step
            # sizes make it monotone) that raised the objective beyond
            # rounding noise, means the step size is invalid
            blowup = restarted and bool(
                obj_c > s.obj + _F32(256.0) * _EPS32 * max(abs(s.obj), _F32(1.0)))
            health, backoff = s.health, s.backoff
            if not finite or blowup:
                w_c, b_c, u_c, obj_c = s.w, s.b, s.u, s.obj
                t_next, rel = _F32(1.0), inf
                health, backoff = health + 1, backoff * _F32(0.5)
            s = FistaState(
                w=w_c, b=b_c, w_prev=s.w, b_prev=s.b, u=u_c, u_prev=s.u,
                t=t_next, k=s.k + 1, obj=obj_c, rel_change=_F32(rel),
                rel_prev=s.rel_change, rel_prev2=s.rel_prev,
                health=health, backoff=backoff)

    return FistaResult(w=s.w, b=s.b, obj=float(s.obj), n_iters=s.k,
                       converged=bool(s.rel3() <= tol), u=s.u, health=s.health)
