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

:func:`fista_solve_dynamic` runs the same iteration in segments of
``screen_every`` and re-screens features (and, on request, samples) between
segments from the duality gap at the current iterate: the at-lambda VI
region collapses onto ``theta*`` as the gap closes, so features screened
there are provably inactive at this lambda (reference ``_dynamic_run``).

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

from ..kernels.ops import hinge_grad_op, margin_obj_op, screen_bounds_from_shared
from .screening import SAFE_TAU, shared_scalars_from_stats

__all__ = [
    "FistaState",
    "FistaResult",
    "DynamicFistaResult",
    "MAX_GUARD_TRIPS",
    "HEALTH_SCREEN_REFUSED",
    "lipschitz_estimate",
    "soft_threshold",
    "fista_solve",
    "fista_solve_dynamic",
    "gap_theta_delta",
    "refresh_bounds",
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


def _init_state(X, y, lam, w0, b0, sm, valid_m) -> FistaState:
    """The first state: the warm start sanitized (``w = 0`` is always
    feasible; a poisoned start counts one trip) and its fused sweep, with
    one fetch."""
    bad0 = ~(torch.isfinite(w0).all() & torch.isfinite(b0))
    w0 = torch.where(torch.isfinite(w0), w0, torch.zeros_like(w0))
    b0 = torch.where(torch.isfinite(b0), b0, torch.zeros_like(b0))
    u0, obj0 = _margin_obj_sweep(X, y, float(lam), w0, b0, sm, valid_m)
    obj0_h, bad0_h = torch.stack([obj0, bad0.to(obj0.dtype)]).tolist()
    inf = _F32(np.inf)
    return FistaState(w=w0, b=b0, w_prev=w0, b_prev=b0, u=u0, u_prev=u0,
                      t=_F32(1.0), k=0, obj=_F32(obj0_h), rel_change=inf,
                      rel_prev=inf, rel_prev2=inf, health=int(bad0_h > 0.5),
                      backoff=_F32(1.0))


def _make_fista_body(X, y, lam, inv_L, sm, fmask=None, valid_m=None):
    """One FISTA iteration ``FistaState -> FistaState``, shared by
    :func:`fista_solve` and the segments of :func:`fista_solve_dynamic`.

    ``fmask`` (0/1 over features, optional) freezes screened coordinates at
    zero: the prox output is masked, so a zeroed coordinate stays zero,
    which is the problem with those rows removed. Two sweeps of X, two more
    when the monotone restart fires; one fetch, two with the restart.
    """
    inf = _F32(np.inf)

    def prox_from(w_a, b_a, u_a, inv_Le):
        """One proximal-gradient step from ``(w_a, b_a)`` whose margins
        ``u_a = X^T w_a`` are known. Two sweeps of X."""
        xi = torch.clamp_min(1.0 - y * (u_a + b_a), 0.0)
        if sm is not None:
            xi = xi * sm
        gw = hinge_grad_op(X, y, xi, valid_m)
        gb = -torch.sum(y * xi)
        w_new = soft_threshold(w_a - float(inv_Le) * gw, float(lam * inv_Le))
        if fmask is not None:
            w_new = w_new * fmask
        b_new = b_a - float(inv_Le) * gb
        u_new, obj_new = _margin_obj_sweep(X, y, float(lam), w_new, b_new,
                                           sm, valid_m)
        return w_new, b_new, u_new, obj_new

    def body(s: FistaState) -> FistaState:
        inv_Le = inv_L * s.backoff
        t_next = _F32(0.5) * (_F32(1.0)
                              + np.sqrt(_F32(1.0) + _F32(4.0) * s.t * s.t))
        beta = float((s.t - _F32(1.0)) / t_next)
        zw = s.w + beta * (s.w - s.w_prev)
        zb = s.b + beta * (s.b - s.b_prev)
        uz = s.u + beta * (s.u - s.u_prev)
        w_c, b_c, u_c, obj_d = prox_from(zw, zb, uz, inv_Le)
        obj_c, finite = _fetch(obj_d, w_c, b_c)

        # monotone restart: the extrapolated step raised the objective, so
        # take a plain proximal step from (w, b) instead (a NaN objective
        # compares False and falls through to the guard)
        restarted = bool(obj_c > s.obj)
        if restarted:
            w_c, b_c, u_c, obj_d = prox_from(s.w, s.b, s.u, inv_Le)
            obj_c, finite = _fetch(obj_d, w_c, b_c)
            t_next = _F32(1.0)
        # a restart iteration is not convergence evidence
        rel = inf if restarted else (
            abs(s.obj - obj_c) / max(abs(s.obj), _F32(1e-30)))

        # guard: a non-finite candidate, or a plain step (valid step sizes
        # make it monotone) that raised the objective beyond rounding
        # noise, means the step size is invalid
        blowup = restarted and bool(
            obj_c > s.obj + _F32(256.0) * _EPS32 * max(abs(s.obj), _F32(1.0)))
        health, backoff = s.health, s.backoff
        if not finite or blowup:
            w_c, b_c, u_c, obj_c = s.w, s.b, s.u, s.obj
            t_next, rel = _F32(1.0), inf
            health, backoff = health + 1, backoff * _F32(0.5)
        return FistaState(
            w=w_c, b=b_c, w_prev=s.w, b_prev=s.b, u=u_c, u_prev=s.u,
            t=t_next, k=s.k + 1, obj=obj_c, rel_change=_F32(rel),
            rel_prev=s.rel_change, rel_prev2=s.rel_prev,
            health=health, backoff=backoff)

    return body


def _setup(X, y, lam, w0, b0, L, tol):
    """Defaults and step size shared by both solvers: ``(lam, w0, b0,
    inv_L, tol)``, the scalars as numpy fp32."""
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
    return lam, w0, b0, _F32(1.0) / L, _F32(tol)


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
    lam, w0, b0, inv_L, tol = _setup(X, y, lam, w0, b0, L, tol)
    s = _init_state(X, y, lam, w0, b0, sample_mask, valid_m)
    body = _make_fista_body(X, y, lam, inv_L, sample_mask, None, valid_m)
    with np.errstate(all="ignore"):
        while s.k < max_iters and s.rel3() > tol and s.health < MAX_GUARD_TRIPS:
            s = body(s)
    return FistaResult(w=s.w, b=s.b, obj=float(s.obj), n_iters=s.k,
                       converged=bool(s.rel3() <= tol), u=s.u, health=s.health)


def gap_theta_delta(X, y, w, b, lam, sample_mask: Optional[torch.Tensor] = None,
                    n_feas_iters: int = 4, u: Optional[torch.Tensor] = None):
    """Gap-certified ``(theta, delta, gap)`` at the current iterate, all on
    X's device (reference ``solver.gap_theta_delta``).

    The sample-masked form of ``dual.safe_theta_and_delta``: with a 0/1
    ``sample_mask`` the certified problem has the masked columns removed, so
    the projection pins their dual coordinates at zero and the equality
    projection uses the live count ``n_eff = sum(sample_mask)``. ``u``
    (optional) is ``X^T w``, carried by the solver, which saves a sweep;
    the ``X (y alpha)`` products are plain GEMVs. The gap is floored at
    ``4 eps |p_obj|`` (cancellation must not shrink delta), and a
    non-finite gap, delta or theta sets ``delta = gap = inf``.
    """
    sm = sample_mask
    lam_t = torch.full((), float(_F32(float(lam))), dtype=X.dtype, device=X.device)
    if u is None:
        u = torch.mv(X.t(), w)
    xi = torch.clamp_min(1.0 - y * (u + b), 0.0)
    if sm is not None:
        xi = xi * sm
    alpha = xi
    p_obj = 0.5 * torch.sum(alpha * alpha) + lam_t * torch.sum(torch.abs(w))
    n_eff = (torch.sum(sm) if sm is not None
             else torch.full((), float(y.shape[0]), dtype=X.dtype, device=X.device))

    def corr_scale(a):
        mx = torch.max(torch.abs(torch.mv(X, y * a)))  # max_j |fhat_j^T a|
        return torch.clamp_max(lam_t / torch.clamp_min(mx, 1e-30), 1.0)

    for _ in range(n_feas_iters):
        alpha = alpha * corr_scale(alpha)
        alpha = torch.clamp_min(alpha - (alpha @ y) / n_eff * y, 0.0)
        if sm is not None:
            alpha = alpha * sm
    alpha = alpha * corr_scale(alpha)  # the inequality constraints hold for sure
    d_obj = torch.sum(alpha) - 0.5 * torch.sum(alpha * alpha)
    gap = torch.clamp_min(p_obj - d_obj, 0.0)
    gap = torch.maximum(gap, 4.0 * _EPS32 * torch.abs(p_obj))
    eq_resid = torch.abs(alpha @ y) / torch.sqrt(n_eff)
    delta = (torch.sqrt(2.0 * gap) + 2.0 * eq_resid) / lam_t
    theta = alpha / lam_t
    cert_ok = (torch.isfinite(gap) & torch.isfinite(delta)
               & torch.isfinite(theta).all())
    inf = torch.full((), float("inf"), dtype=X.dtype, device=X.device)
    return theta, torch.where(cert_ok, delta, inf), torch.where(cert_ok, gap, inf)


def refresh_bounds(X, y, lam, theta, delta,
                   sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The in-solver feature bounds at ``lam`` (reference ``_dynamic_run``):
    the at-lambda VI region (``lam1 = lam2 = lam``) from the certified
    ``(theta, delta)``, with its theta-independent statistics taken over the
    live samples only, capped elementwise by the gap sphere's
    ``|f.(y theta)| + ||f|| delta`` (NaN-propagating min). One launch of the
    feature screen's dynamic variant on a CUDA X, its plain version on a
    CPU X."""
    s = sample_mask
    lam_t = torch.full((), float(_F32(float(lam))), dtype=theta.dtype,
                       device=theta.device)
    if s is None:
        one_y, n_tot = torch.sum(y), torch.full_like(lam_t, float(y.shape[0]))
    else:
        one_y, n_tot = torch.sum(y * s), torch.sum(s)
    sh = shared_scalars_from_stats(
        lam_t, lam_t, one_y=one_y, theta_dot_one=torch.sum(theta),
        theta_dot_y=theta @ y, theta_sq=theta @ theta, n_tot=n_tot,
        delta=delta)
    return screen_bounds_from_shared(X, y, theta, sh, weights=s, cap_delta=delta)


class DynamicFistaResult(NamedTuple):
    """:class:`FistaResult` plus in-solver screening telemetry.

    ``kept_per_segment[s]`` is the live-feature count after segment ``s``'s
    refresh and ``gap_per_segment[s]`` the gap it certified from (host
    numpy, length ``ceil(max_iters / screen_every)``); slots never run hold
    ``-1`` / ``inf``. With ``dynamic_samples`` the final live sample mask
    and the per-segment live-sample counts too: that screen is
    margin-predicted, and the caller must verify it at the solution.
    """

    w: torch.Tensor
    b: torch.Tensor
    obj: float
    n_iters: int
    converged: bool
    feature_mask: torch.Tensor          # (m,) bool, final live mask
    kept_per_segment: np.ndarray        # (S,) int64
    gap_per_segment: np.ndarray         # (S,) float64
    n_segments: int
    u: torch.Tensor
    sample_mask: Optional[torch.Tensor] = None            # (n,) bool
    kept_samples_per_segment: Optional[np.ndarray] = None  # (S,) int64
    health: int = 0


def fista_solve_dynamic(
    X: torch.Tensor,
    y: torch.Tensor,
    lam,
    w0: Optional[torch.Tensor] = None,
    b0=None,
    max_iters: int = 2000,
    tol: float = 1e-9,
    L=None,
    sample_mask: Optional[torch.Tensor] = None,
    feature_mask: Optional[torch.Tensor] = None,
    screen_every: int = 50,
    tau: float = SAFE_TAU,
    n_feas_iters: int = 4,
    valid_m: Optional[int] = None,
    dynamic_samples: bool = False,
    sample_dw: float = float("inf"),
    sample_db: float = float("inf"),
    sample_u_prev: Optional[torch.Tensor] = None,
    sample_shrink_factor: float = 2.0,
    sample_margin_floor: float = 1e-3,
) -> DynamicFistaResult:
    """Segmented FISTA with gap-driven dynamic feature screening (reference
    ``solver.fista_solve_dynamic`` and ``_dynamic_run``).

    Solves the problem of :func:`fista_solve`, and every ``screen_every``
    iterations (a) certifies ``(theta, delta, gap)`` at the current iterate
    from the carried margins (:func:`gap_theta_delta`, under the sample
    mask the segment ran with), (b) bounds every live feature over the
    at-lambda region capped by the gap sphere (:func:`refresh_bounds`), and
    (c) multiplies the keep mask ``~(bounds < tau) | ~isfinite(delta)``
    into the live ``feature_mask``, which only shrinks. When the masks moved
    the problem the state restarts at the masked point (momentum and the
    stop rule's history reset, one margin sweep). A refused refresh (a
    non-finite certificate) keeps every feature and sets
    :data:`HEALTH_SCREEN_REFUSED`; the trip bound reads the low bits only.

    ``feature_mask`` (0/1 over rows) seeds the live mask; ``valid_m`` marks
    the live leading rows of a gather bucket: the rows past it stay out of
    the mask, and the certificate and the screen read ``X[:valid_m]``.

    ``dynamic_samples=True`` also re-screens samples at each refresh, from
    the carried margins ``u + b`` and the column norms of X (one reduction
    per solve) against the radii ``sample_dw`` / ``sample_db`` and the
    secant from ``sample_u_prev`` (``rules/sample_vi.margin_surplus_core``;
    NaN-safe, ``~(surplus >= 0)`` keeps). Those drops are predicted, not
    safe: the caller verifies them at the solution.

    Host cost per refresh: one batched fetch, and one more for the
    restart's objective when the masks moved.
    """
    from .rules.sample_vi import margin_surplus_core  # lazy: rules import the solver

    m = X.shape[0]
    dev, dtype = X.device, X.dtype
    lam, w0, b0, inv_L, tol = _setup(X, y, lam, w0, b0, L, tol)
    screen_every = max(int(screen_every), 1)
    n_seg = -(-max_iters // screen_every)
    fmask = (torch.ones((m,), dtype=dtype, device=dev) if feature_mask is None
             else torch.as_tensor(feature_mask).to(device=dev, dtype=dtype).clone())
    if valid_m is not None:
        fmask[valid_m:] = 0.0
    w0 = w0 * fmask
    # the mask the segments run with: a live sample mask with dynamic_samples
    smask = sample_mask
    if dynamic_samples:
        smask = torch.ones_like(y) if smask is None else smask
        # ||x_i||^2 from one reduction: no X * X copy (2 GB at full width)
        x_sq = torch.square(torch.linalg.vector_norm(X, dim=0, dtype=torch.float32))
    # the rows the certificate and the screen read (all of X at valid_m = 0:
    # its rows are zero padding there, and a kernel needs one row)
    live = valid_m if valid_m else m
    rows = X[:live]

    s = _init_state(X, y, lam, w0, b0, sample_mask, valid_m)
    kept = np.full((n_seg,), -1, dtype=np.int64)
    gaps = np.full((n_seg,), np.inf, dtype=np.float64)
    kept_s = np.full((n_seg,), -1, dtype=np.int64)
    seg = 0
    inf = _F32(np.inf)

    def go(st, k_stop):
        # the trip bound reads the low bits: a refused refresh is telemetry
        trips = st.health & (HEALTH_SCREEN_REFUSED - 1)
        return st.k < k_stop and st.rel3() > tol and trips < MAX_GUARD_TRIPS

    with np.errstate(all="ignore"):
        while go(s, max_iters):
            # -- segment: up to screen_every iterations on the live masks
            body = _make_fista_body(X, y, lam, inv_L, smask, fmask, valid_m)
            k_stop = min(s.k + screen_every, max_iters)
            while go(s, k_stop):
                s = body(s)

            # -- refresh: the region certified at the current iterate
            theta, delta, gap = gap_theta_delta(
                rows, y, s.w[:live], s.b, lam, smask, n_feas_iters, u=s.u)
            bounds = refresh_bounds(rows, y, lam, theta, delta, smask)
            cert_ok = torch.isfinite(delta)
            keep = (~(bounds < tau)) | ~cert_ok
            new_mask = fmask.clone()
            new_mask[:live] *= keep.to(dtype)
            new_sm = smask
            if dynamic_samples:
                surplus = margin_surplus_core(
                    s.u + s.b, y, x_sq, sample_dw, sample_db,
                    u_prev=sample_u_prev, shrink_factor=sample_shrink_factor,
                    margin_floor=sample_margin_floor)
                new_sm = smask * (~(surplus >= 0.0)).to(dtype)
            w_m = s.w * new_mask
            moved = torch.sum((s.w - w_m) * (s.w - w_m)) > 0.0
            stats = [cert_ok, torch.sum(new_mask), gap]
            if dynamic_samples:
                moved = moved | (torch.sum(smask - new_sm) > 0.0)
                stats.append(torch.sum(new_sm))
            stats = torch.stack([moved.double()]
                                + [v.double() for v in stats]).tolist()

            if stats[0] > 0.5:
                # the masks moved the problem: restart at the masked point
                u_m, obj_m = _margin_obj_sweep(X, y, float(lam), w_m, s.b,
                                               new_sm, valid_m)
                s = FistaState(
                    w=w_m, b=s.b, w_prev=w_m, b_prev=s.b, u=u_m, u_prev=u_m,
                    t=_F32(1.0), k=s.k, obj=_F32(obj_m.item()), rel_change=inf,
                    rel_prev=inf, rel_prev2=inf, health=s.health,
                    backoff=s.backoff)
            if stats[1] < 0.5:
                s = s._replace(health=s.health | HEALTH_SCREEN_REFUSED)
            # more refreshes than slots are possible (a restart after inner
            # convergence): the last slot takes the rest
            slot = min(seg, n_seg - 1)
            kept[slot], gaps[slot] = int(stats[2]), stats[3]
            if dynamic_samples:
                kept_s[slot] = int(stats[4])
            seg = min(seg + 1, n_seg)
            fmask, smask = new_mask, new_sm

    return DynamicFistaResult(
        w=s.w, b=s.b, obj=float(s.obj), n_iters=s.k,
        converged=bool(s.rel3() <= tol), feature_mask=fmask > 0.5,
        kept_per_segment=kept, gap_per_segment=gaps, n_segments=seg, u=s.u,
        sample_mask=(smask > 0.5) if dynamic_samples else None,
        kept_samples_per_segment=kept_s if dynamic_samples else None,
        health=s.health)
