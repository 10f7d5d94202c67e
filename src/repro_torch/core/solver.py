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

Two loops run the same iteration. :func:`fista_solve` (the host engine's)
is host control flow over device tensors: each iteration fetches one small
tensor (the candidate objective and a finiteness flag) to decide the
monotone restart, the health guard and the stop rule; the restart pays its
two sweeps only when it fires (and one more fetch). Scalars the reference
carries in fp32 (``t``, the objective history, the step backoff) are kept
as numpy float32 on the host, so the decisions are taken in the same
precision.

:func:`fista_run` (the scan engines', reference ``fista_run``) decides on
the device: the scalars are 0-d fp32/int32 tensors and the restart, the
guard and the three-tie stop rule are ``torch.where`` selects, the same
fp32 operations as the host loop's, so both count the same iterations. It
runs in chunks of :data:`CHUNK_ITERS` iterations; an iteration after the
stop leaves the state bit for bit unchanged. The restart's two sweeps are
launches predicated on "a restart fired" and every sweep on "not stopped"
(``kernels/hinge.py``): they read X only when they count. On a CUDA X one
chunk is a captured ``torch.cuda.CUDAGraph``, replayed, and the host
fetches the ``go`` flag once a chunk; the graphs are cached by their static
inputs (:func:`graph_cache_info`). On a CPU X the chunk runs eagerly.
:func:`fista_run_dynamic` runs it in segments with the dynamic refresh on
the device between them, one fetch a segment. :data:`FETCHES` counts the
host fetches of both loops, :data:`GRAPHS` the captures and replays.

The reduction seam (:class:`Collectives`, reference ``solver.py``): the
scan engines' loop, the certificate, the dynamic refresh and the Lipschitz
estimate take ``col``, four reductions over the two axes of a sharded X
(``core/distributed.py``): margins and L1 norms over the feature axis,
gradients and losses over the sample axis. :data:`LOCAL` binds them to the
identity, the single-device program, op for op. Under a sharded seam X is
the rank's block; margins come from the margin kernel's partial mode, the
all-reduce and its finalize (``kernels/hinge.py``); every decision reads
all-reduced values (the guard's non-finite test the all-reduced
objective), so every rank takes it alike; the chunks run eagerly (a
collective of another process cannot be captured),
and the host reads the all-reduced ``go`` and restart flags each iteration
(``FETCHES["sharded"]``), so a restart's sweeps and collectives run only
when it fires, as under the reference's ``lax.cond``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ops import (
    hinge_grad_op,
    margin_finalize_op,
    margin_obj_op,
    margin_partial_op,
    screen_bounds_edpp,
    screen_bounds_from_shared,
    screen_finalize_op,
    screen_partial_op,
)
from .screening import SAFE_TAU, shared_scalars_from_stats

__all__ = [
    "Collectives",
    "LOCAL",
    "is_local",
    "FistaState",
    "FistaResult",
    "DynamicFistaResult",
    "MAX_GUARD_TRIPS",
    "HEALTH_SCREEN_REFUSED",
    "lipschitz_estimate",
    "soft_threshold",
    "fista_solve",
    "fista_solve_dynamic",
    "fista_run",
    "fista_run_dynamic",
    "gap_theta_delta",
    "refresh_bounds",
    "region_stats",
    "seam_screen_bounds",
    "host_fetch",
    "graph_cache_info",
    "clear_graph_cache",
    "drop_graphs_reading",
    "CHUNK_ITERS",
    "FETCHES",
    "GRAPHS",
]

class Collectives(NamedTuple):
    """The four cross-shard reductions of the solver's math (reference
    ``solver.Collectives``): each takes a tensor and returns its reduction,
    a new tensor, on every rank of the axis."""

    psum_model: object  # sum over the feature axis (margins, sum |w|)
    psum_data: object   # sum over the sample axis (gradients, losses)
    psum_bias: object   # the bias gradient's sum over the samples
    pmax_model: object  # max over the feature axis (dual feasibility, guard)


def _identity(x):
    return x


#: The single-device binding: every reduction is the identity, so the
#: sharded code paths are the local program op for op (a trivial all-reduce
#: would still cost a call, and a grid axis of size 1 binds to this).
LOCAL = Collectives(_identity, _identity, _identity, _identity)


def is_local(col: Collectives) -> bool:
    """True when every reduction of ``col`` is the identity."""
    return all(f is _identity for f in col)


#: Cap on health-guard rollbacks per solve. Each trip halves the step size;
#: a solve still tripping after 8 is unrecoverable (poisoned operands).
MAX_GUARD_TRIPS = 8

#: Bit set in a path step's ``health`` when its screen was refused because
#: the previous certificate was non-finite. Low bits count guard trips.
HEALTH_SCREEN_REFUSED = 1 << 16

_F32 = np.float32
_EPS32 = np.finfo(np.float32).eps
# the guard's rounding slack 256 eps in fp32 (exactly 2**-15)
_GUARD_SLACK = float(_F32(256.0) * _EPS32)

#: iterations of one :func:`fista_run` chunk: one graph replay and one host
#: fetch on the card. An iteration after the stop is a no-op that still
#: costs its launches, so a larger chunk wastes more of them at the end of a
#: solve and a smaller one fetches more often.
CHUNK_ITERS = 8

#: host fetches (device-to-host reads that decide control flow) in this
#: process, by kind: ``"host_loop"`` the host engine's solver (one an
#: iteration, two with a restart), ``"chunk"`` :func:`fista_run`'s ``go``
#: flag, ``"segment"`` a dynamic refresh of :func:`fista_run_dynamic`,
#: ``"step"`` a scan-engine step's kept counts (its compact buffer is picked
#: on the host), ``"setup"`` and ``"result"`` a scan path's first and last,
#: ``"sharded"`` a sharded loop's per-iteration reads of ``go`` and of the
#: restart flag.
FETCHES = {"host_loop": 0, "chunk": 0, "segment": 0, "step": 0, "setup": 0,
           "result": 0, "sharded": 0}
#: CUDA graphs of :func:`fista_run` chunks: captures, replays, and
#: re-captures of a cache key already captured (its graph was evicted by the
#: cache's size bound and captured again)
GRAPHS = {"captures": 0, "replays": 0, "recaptures": 0}


def host_fetch(t: torch.Tensor, kind: str):
    """``t.tolist()``, counted as one host fetch of ``kind``."""
    FETCHES[kind] += 1
    return t.tolist()


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
    """A solve's result. :func:`fista_solve` gives ``obj``, ``n_iters``,
    ``converged`` and ``health`` as host numbers, :func:`fista_run` as 0-d
    tensors on X's device (read them once, after the path)."""

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
                       generator: Optional[torch.Generator] = None,
                       row_mask: Optional[torch.Tensor] = None,
                       col: Collectives = LOCAL,
                       cols: Optional[tuple] = None) -> torch.Tensor:
    """Power iteration for ``sigma_max([X; 1^T])^2`` (augmented bias row).

    100 iterations, not the reference's 30: on the 2000 x 400 bench instance
    (seed 0) 30 iterations stop 3.5% below the true value, which makes the
    step ``1 / (1.01 L)`` too long; 100 stay within 0.1%, and cost two GEMVs
    each, once per path. The start vector is standard normal from
    ``generator`` (default: a CPU generator seeded 0, so CPU and CUDA runs
    start alike). Returns a 0-d tensor on X's device; it never exceeds the
    true value beyond rounding. ``row_mask`` (0/1 over rows) estimates for
    ``X * row_mask[:, None]`` without making that copy of X.

    Sharded (``col`` not :data:`LOCAL`): X is the rank's block and ``cols =
    (first column, n of the whole X)``; every rank draws the whole start
    vector and takes its columns, so the estimate starts where the
    single-device one does, and the two GEMVs and the norms are reduced
    over the grid (reference ``lipschitz_estimate(col=)``).
    """
    n = X.shape[1]
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    c0, n_all = cols if cols is not None else (0, n)
    v = torch.randn(n_all, generator=generator, device=generator.device,
                    dtype=X.dtype)[c0:c0 + n].to(X.device)

    def norm(v):
        if col.psum_data is _identity:
            return torch.linalg.vector_norm(v)
        return torch.sqrt(col.psum_data(torch.sum(v * v)))

    for _ in range(n_iters):
        v = v / torch.clamp_min(norm(v), 1e-30)
        u_w = col.psum_data(torch.mv(X, v))
        if row_mask is not None:
            u_w = u_w * row_mask
        v = col.psum_model(torch.mv(X.t(), u_w)) + col.psum_data(torch.sum(v))
    return norm(v)  # ||A^T A v|| with ||v|| = 1


def _margin_obj_sweep(X, y, lam, w, b, sm, valid_m, flag=None, col=LOCAL):
    """One fused pass over X: ``(u = X^T w, objective(w, b))``. With a sample
    mask the O(n) masked loss is recomputed from the returned slacks.
    ``flag``: the sweep's predicate (``kernels/hinge.py``). Under a seam
    that sums over features, the margin kernel's partial mode, then one
    all-reduce of the partial margins with the rank's ``sum |w|`` packed
    behind them, then the kernel's finalize; the loss is then summed over
    samples."""
    l1 = torch.sum(torch.abs(w))
    if col.psum_model is _identity:
        u, xi, loss = margin_obj_op(X, w, y, b, valid_m, flag)
    else:
        packed = col.psum_model(torch.cat([margin_partial_op(X, w, valid_m, flag),
                                           l1.reshape(1)]))
        u, xi, loss = margin_finalize_op(packed[:-1], y, b, flag)
        l1 = packed[-1]
    if sm is not None:
        xi = xi * sm
        loss = 0.5 * torch.sum(xi * xi)
    return u, col.psum_data(loss) + lam * l1


def _fetch(obj: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """The one host sync of an iteration: ``(objective, all finite)``."""
    finite = torch.isfinite(w).all() & torch.isfinite(b)
    obj_h, fin_h = host_fetch(torch.stack([obj, finite.to(obj.dtype)]), "host_loop")
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
    obj0_h, bad0_h = host_fetch(torch.stack([obj0, bad0.to(obj0.dtype)]),
                                "host_loop")
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


def _scalar(v, dtype, device) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``dtype`` on ``device``: a tensor converted
    there, a number rounded to fp32 on the host and filled in (a fill, not a
    host-to-device copy, which would synchronise the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=device).reshape(())
    return torch.full((), float(_F32(float(v))), dtype=dtype, device=device)


def gap_theta_delta(X, y, w, b, lam, sample_mask: Optional[torch.Tensor] = None,
                    n_feas_iters: int = 4, u: Optional[torch.Tensor] = None,
                    col: Collectives = LOCAL):
    """Gap-certified ``(theta, delta, gap)`` at the current iterate, all on
    X's device (reference ``solver.gap_theta_delta``).

    The sample-masked form of ``dual.safe_theta_and_delta``: with a 0/1
    ``sample_mask`` the certified problem has the masked columns removed, so
    the projection pins their dual coordinates at zero and the equality
    projection uses the live count ``n_eff = sum(sample_mask)``. ``u``
    (optional) is ``X^T w``, carried by the solver, which saves a sweep;
    the ``X (y alpha)`` products are plain GEMVs. The gap is floored at
    ``4 eps |p_obj|`` (cancellation must not shrink delta), and a
    non-finite gap, delta or theta sets ``delta = gap = inf``. ``lam`` is a
    number or a 0-d tensor on X's device (the scan engines': no host read).
    ``col``: the reductions of a sharded X, at the reference's places; the
    rank's theta is finite whenever the all-reduced gap is (its sums enter
    the gap), so a sharded certificate tests the gap and delta only.
    """
    sm = sample_mask
    lam_t = _scalar(lam, X.dtype, X.device)
    if u is None:
        u = col.psum_model(torch.mv(X.t(), w))
    xi = torch.clamp_min(1.0 - y * (u + b), 0.0)
    if sm is not None:
        xi = xi * sm
    alpha = xi
    p_obj = (col.psum_data(0.5 * torch.sum(alpha * alpha))
             + lam_t * col.psum_model(torch.sum(torch.abs(w))))
    n_eff = col.psum_data(
        torch.sum(sm) if sm is not None
        else torch.full((), float(y.shape[0]), dtype=X.dtype, device=X.device))

    def corr_scale(a):
        # max_j |fhat_j^T a|
        mx = col.pmax_model(torch.max(torch.abs(col.psum_data(torch.mv(X, y * a)))))
        return torch.clamp_max(lam_t / torch.clamp_min(mx, 1e-30), 1.0)

    for _ in range(n_feas_iters):
        alpha = alpha * corr_scale(alpha)
        alpha = torch.clamp_min(alpha - col.psum_data(alpha @ y) / n_eff * y, 0.0)
        if sm is not None:
            alpha = alpha * sm
    alpha = alpha * corr_scale(alpha)  # the inequality constraints hold for sure
    d_obj = (col.psum_data(torch.sum(alpha))
             - 0.5 * col.psum_data(torch.sum(alpha * alpha)))
    gap = torch.clamp_min(p_obj - d_obj, 0.0)
    gap = torch.maximum(gap, 4.0 * _EPS32 * torch.abs(p_obj))
    eq_resid = torch.abs(col.psum_data(alpha @ y)) / torch.sqrt(n_eff)
    delta = (torch.sqrt(2.0 * gap) + 2.0 * eq_resid) / lam_t
    theta = alpha / lam_t
    cert_ok = torch.isfinite(gap) & torch.isfinite(delta)
    if is_local(col):
        cert_ok = cert_ok & torch.isfinite(theta).all()
    inf = torch.full((), float("inf"), dtype=X.dtype, device=X.device)
    return theta, torch.where(cert_ok, delta, inf), torch.where(cert_ok, gap, inf)


def refresh_bounds(X, y, lam, theta, delta,
                   sample_mask: Optional[torch.Tensor] = None,
                   col: Collectives = LOCAL) -> torch.Tensor:
    """The in-solver feature bounds at ``lam`` (reference ``_dynamic_run``):
    the at-lambda VI region (``lam1 = lam2 = lam``) from the certified
    ``(theta, delta)``, with its theta-independent statistics taken over the
    live samples only, capped elementwise by the gap sphere's
    ``|f.(y theta)| + ||f|| delta`` (NaN-propagating min). One launch of the
    feature screen's dynamic variant on a CUDA X, its plain version on a
    CPU X. Sharded over samples (``col``): the screen's partial mode (its
    weighted instantiation under a sample mask), the all-reduce of the four
    sums and the kernel's finalize with the cap, from all-reduced
    statistics; over features only, the dynamic variant on the rank's
    rows."""
    lam_t = _scalar(lam, theta.dtype, theta.device)
    sh = shared_scalars_from_stats(lam_t, lam_t, **region_stats(y, theta, col,
                                                                 sample_mask),
                                   delta=delta)
    return seam_screen_bounds(X, y, theta, sh, col, weights=sample_mask,
                              cap_delta=delta)


def region_stats(y, theta, col: Collectives = LOCAL,
                 weights: Optional[torch.Tensor] = None,
                 statics: Optional[tuple] = None) -> dict:
    """The sample statistics of the region anchored at ``theta``: the
    keywords ``one_y``, ``theta_dot_one``, ``theta_dot_y``, ``theta_sq`` and
    ``n_tot`` of ``screening.shared_scalars_from_stats``. ``statics = (one_y,
    n_tot)`` when they are known and global (a path's), else taken over the
    live samples ``weights`` (all without). Sharded over samples (``col``):
    what is not global yet is summed in one all-reduce."""
    st = [torch.sum(theta), theta @ y, theta @ theta]
    if statics is None:
        st += ([torch.sum(y), torch.full_like(st[0], float(y.shape[0]))]
               if weights is None else [torch.sum(y * weights), torch.sum(weights)])
    if col.psum_data is not _identity:
        st = list(col.psum_data(torch.stack(st)))
    one_y, n_tot = st[3:] if statics is None else statics
    return dict(one_y=one_y, theta_dot_one=st[0], theta_dot_y=st[1], theta_sq=st[2],
                n_tot=n_tot)


def seam_screen_bounds(X, y, theta, sh, col: Collectives = LOCAL, *,
                       weights: Optional[torch.Tensor] = None, cap_delta=None,
                       edpp=None) -> torch.Tensor:
    """The feature screen's bounds of X's rows under the seam, from the
    region's global scalars ``sh`` (and ``edpp``'s, for the EDPP mode). With
    the sample axis whole, one launch on X's rows (``weights``: its weighted
    instantiation, in either mode; ``cap_delta``: the gap-sphere cap).
    Sharded over samples: its partial mode, the all-reduce of the four sums,
    and its finalize."""
    if col.psum_data is _identity:
        if edpp is not None:
            return screen_bounds_edpp(X, y, theta, sh, edpp, weights=weights)
        return screen_bounds_from_shared(X, y, theta, sh, weights=weights,
                                         cap_delta=cap_delta)
    sums = col.psum_data(screen_partial_op(X, y, theta, weights=weights))
    return screen_finalize_op(sums, sh, cap_delta=cap_delta, edpp=edpp)


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


# -- fista_run: the FISTA loop decided on the device ---------------------------


class RunState(NamedTuple):
    """:func:`fista_run`'s iterate: :class:`FistaState` with every scalar a
    0-d tensor on X's device (fp32; ``k`` and ``health`` int32), and ``go``,
    the bool the stop rule leaves: the solve runs on."""

    w: torch.Tensor
    b: torch.Tensor
    w_prev: torch.Tensor
    b_prev: torch.Tensor
    u: torch.Tensor
    u_prev: torch.Tensor
    t: torch.Tensor
    k: torch.Tensor
    obj: torch.Tensor
    rel_change: torch.Tensor
    rel_prev: torch.Tensor
    rel_prev2: torch.Tensor
    health: torch.Tensor
    backoff: torch.Tensor
    go: torch.Tensor


class RunConsts(NamedTuple):
    """The scalars a chunk reads, 0-d tensors on X's device: ``lam``,
    ``inv_L``, ``tol`` (fp32) and ``k_stop`` (int32, the iteration count at
    which the solve, or the dynamic segment, stops)."""

    lam: torch.Tensor
    inv_L: torch.Tensor
    tol: torch.Tensor
    k_stop: torch.Tensor


def _consts(lam, inv_L, tol, k_stop, device) -> RunConsts:
    f32 = torch.float32
    return RunConsts(_scalar(lam, f32, device), _scalar(inv_L, f32, device),
                     _scalar(tol, f32, device),
                     torch.full((), int(k_stop), dtype=torch.int32, device=device))


def _rel3_t(s: RunState) -> torch.Tensor:
    return torch.maximum(torch.maximum(s.rel_change, s.rel_prev), s.rel_prev2)


def _go(s: RunState, c: RunConsts) -> torch.Tensor:
    """The stop rule of the host loop: below ``k_stop``, no three
    consecutive sub-tol iterations yet, fewer than MAX_GUARD_TRIPS guard
    trips (the low bits: a refused refresh does not stop a solve)."""
    trips = torch.bitwise_and(s.health, HEALTH_SCREEN_REFUSED - 1)
    return (s.k < c.k_stop) & (_rel3_t(s) > c.tol) & (trips < MAX_GUARD_TRIPS)


def _agreed(bad: torch.Tensor, col: Collectives) -> torch.Tensor:
    """A rank's verdict on its block of w, made every rank's: a max over
    the feature axis (the identity locally)."""
    return bad if is_local(col) else col.pmax_model(bad.to(torch.float32)) > 0.5


def _run_init(X, y, c: RunConsts, w0, b0, sm, valid_m, col=LOCAL) -> RunState:
    """The first state, as the host loop's :func:`_init_state` makes it
    (warm start sanitized, one trip for a poisoned one, one fused sweep), on
    the device."""
    dev = X.device
    b0 = _scalar(b0, torch.float32, dev)
    fin_w = torch.isfinite(w0)
    bad0 = _agreed(~(fin_w.all() & torch.isfinite(b0)), col)
    w0 = torch.where(fin_w, w0, torch.zeros_like(w0))
    b0 = torch.where(torch.isfinite(b0), b0, torch.zeros_like(b0))
    u0, obj0 = _margin_obj_sweep(X, y, c.lam, w0, b0, sm, valid_m, col=col)
    one = torch.ones((), dtype=torch.float32, device=dev)
    inf = torch.full((), np.inf, dtype=torch.float32, device=dev)
    s = RunState(w=w0, b=b0, w_prev=w0, b_prev=b0, u=u0, u_prev=u0, t=one,
                 k=torch.zeros((), dtype=torch.int32, device=dev), obj=obj0,
                 rel_change=inf, rel_prev=inf, rel_prev2=inf,
                 health=bad0.to(torch.int32), backoff=one, go=bad0)
    return s._replace(go=_go(s, c))


def _run_prox(X, y, c, sm, fmask, valid_m, w_a, b_a, u_a, inv_Le, thr, flag,
              col=LOCAL):
    """One proximal-gradient step from ``(w_a, b_a)`` with margins ``u_a``
    (the host loop's ``prox_from``); both sweeps predicated on ``flag``."""
    xi = torch.clamp_min(1.0 - y * (u_a + b_a), 0.0)
    if sm is not None:
        xi = xi * sm
    gw = hinge_grad_op(X, y, xi, valid_m, flag)
    gb = -torch.sum(y * xi)
    if col.psum_bias is col.psum_data and not is_local(col):
        packed = col.psum_data(torch.cat([gw, gb.reshape(1)]))  # one all-reduce
        gw, gb = packed[:-1], packed[-1]
    else:
        gw, gb = col.psum_data(gw), col.psum_bias(gb)
    w_new = soft_threshold(w_a - inv_Le * gw, thr)
    if fmask is not None:
        w_new = w_new * fmask
    b_new = b_a - inv_Le * gb
    u_new, obj_new = _margin_obj_sweep(X, y, c.lam, w_new, b_new, sm, valid_m, flag,
                                       col)
    return w_new, b_new, u_new, obj_new


def _run_body(X, y, sm, fmask, valid_m, c: RunConsts, s: RunState,
              col: Collectives = LOCAL) -> RunState:
    """One iteration of the host loop's body with its decisions as selects.
    With ``go`` false every field comes back unchanged and both sweeps are
    switched off. Under a sharded seam the restart's step runs only when the
    host reads that it fired."""
    go = s.go
    inv_Le = c.inv_L * s.backoff
    thr = c.lam * inv_Le
    t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * s.t * s.t))
    beta = (s.t - 1.0) / t_next
    zw = s.w + beta * (s.w - s.w_prev)
    zb = s.b + beta * (s.b - s.b_prev)
    uz = s.u + beta * (s.u - s.u_prev)
    args = (X, y, c, sm, fmask, valid_m)
    w_c, b_c, u_c, obj_c = _run_prox(*args, zw, zb, uz, inv_Le, thr, go.to(torch.int32),
                                     col)
    # monotone restart: a plain step from (w, b), its sweeps switched off
    # unless it fires
    restarted = go & (obj_c > s.obj)
    if is_local(col) or host_fetch(restarted, "sharded"):
        w_r, b_r, u_r, obj_r = _run_prox(*args, s.w, s.b, s.u, inv_Le, thr,
                                         restarted.to(torch.int32), col)
    else:  # not fired: the selects below keep the candidate
        w_r, b_r, u_r, obj_r = w_c, b_c, u_c, obj_c
    # a restart iteration is not convergence evidence
    rel = torch.where(restarted, np.inf, torch.abs(s.obj - obj_c)
                      / torch.clamp_min(torch.abs(s.obj), 1e-30))
    w_c = torch.where(restarted, w_r, w_c)
    b_c = torch.where(restarted, b_r, b_c)
    u_c = torch.where(restarted, u_r, u_c)
    obj_c = torch.where(restarted, obj_r, obj_c)
    t_next = torch.where(restarted, 1.0, t_next)
    # guard: a non-finite candidate, or a restart step that raised the
    # objective beyond rounding, rolls back, halves the step, counts a trip
    # (sharded: a non-finite entry of a rank's w makes the all-reduced
    # sum |w|, so the objective, non-finite on every rank: no max needed)
    finite = torch.isfinite(b_c) & torch.isfinite(obj_c)
    if is_local(col):
        finite = torch.isfinite(w_c).all() & finite
    blowup = restarted & (obj_c > s.obj + _GUARD_SLACK
                          * torch.clamp_min(torch.abs(s.obj), 1.0))
    trip = go & (~finite | blowup)
    ok = go & ~trip
    new = RunState(
        w=torch.where(ok, w_c, s.w), b=torch.where(ok, b_c, s.b),
        w_prev=torch.where(go, s.w, s.w_prev), b_prev=torch.where(go, s.b, s.b_prev),
        u=torch.where(ok, u_c, s.u), u_prev=torch.where(go, s.u, s.u_prev),
        t=torch.where(ok, t_next, torch.where(trip, 1.0, s.t)),
        k=s.k + go.to(torch.int32),
        obj=torch.where(ok, obj_c, s.obj),
        rel_change=torch.where(ok, rel, torch.where(trip, np.inf, s.rel_change)),
        rel_prev=torch.where(go, s.rel_change, s.rel_prev),
        rel_prev2=torch.where(go, s.rel_prev, s.rel_prev2),
        health=s.health + trip.to(torch.int32),
        backoff=torch.where(trip, s.backoff * 0.5, s.backoff), go=go)
    return new._replace(go=go & _go(new, c))


def _run_chunk(X, y, sm, fmask, valid_m, c: RunConsts, s: RunState,
               col: Collectives = LOCAL) -> RunState:
    for _ in range(CHUNK_ITERS):
        if not (is_local(col) or host_fetch(s.go, "sharded")):
            break  # a sharded solve that stopped runs no more collectives
        s = _run_body(X, y, sm, fmask, valid_m, c, s, col)
    return s


class _Chunks:
    """Runs :func:`fista_run`'s chunks for one problem ``(X, y, sm, fmask,
    valid_m)``: eagerly for a CPU X; for a CUDA X as one captured graph over
    static buffers (the state, the scalars, y and the masks are copied in,
    X is read where it lies), cached in :data:`_GRAPH_CACHE`. A chunk's
    first run in a cache entry is eager, on the static buffers: it launches
    every kernel once (the library build, each kernel's first-launch set-up)
    before the capture. ``col``: a sharded seam (eager chunks)."""

    def __init__(self, X, y, sm, fmask, valid_m, col=LOCAL):
        self.X, self.valid_m, self.col = X, valid_m, col
        self.graph, self.counts = None, None
        self.y, self.sm, self.fmask = y, sm, fmask
        self.state = self.consts = None

    def load(self, s: RunState, c: Optional[RunConsts] = None) -> None:
        self.state = s
        if c is not None:
            self.consts = c

    def set_fmask(self, fmask) -> None:
        self.fmask = fmask

    def _chunk(self) -> None:
        self.state = _run_chunk(self.X, self.y, self.sm, self.fmask,
                                self.valid_m, self.consts, self.state, self.col)

    def run(self) -> RunState:
        """Chunks until the stop rule says stop (one fetch a chunk)."""
        while True:
            self._chunk()
            if not host_fetch(self.state.go, "chunk"):
                return self.state


class _GraphChunks(_Chunks):
    """:class:`_Chunks` on the card: one chunk is a captured CUDA graph. X
    is held only until the capture (the graph reads it by address)."""

    def __init__(self, X, y, sm, fmask, valid_m, key=None):
        super().__init__(X, y, sm, fmask, valid_m)
        self.key = key
        self.y = y.clone()
        self.sm = None if sm is None else sm.clone()
        self.fmask = None if fmask is None else fmask.clone()

    def inputs(self, X, y, sm, fmask) -> None:
        if self.graph is None:
            self.X = X
        self.y.copy_(y)
        if sm is not None:
            self.sm.copy_(sm)
        if fmask is not None:
            self.fmask.copy_(fmask)

    def load(self, s: RunState, c: Optional[RunConsts] = None) -> None:
        if self.state is None:
            self.state = RunState(*(t.clone() for t in s))
            self.consts = RunConsts(*(t.clone() for t in c))
            return
        for dst, src in zip(self.state, s):
            if dst is not src:
                dst.copy_(src)
        if c is not None:
            for dst, src in zip(self.consts, c):
                dst.copy_(src)

    def set_fmask(self, fmask) -> None:
        self.fmask.copy_(fmask)

    def _step(self) -> None:
        out = _run_chunk(self.X, self.y, self.sm, self.fmask, self.valid_m,
                         self.consts, self.state)
        for dst, src in zip(self.state, out):
            dst.copy_(src)

    def _chunk(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            GRAPHS["replays"] += 1
            ops.add_counts(self.counts)
            return
        self._step()  # the warm-up, and real work
        before = (ops.launch_counts(), ops.variant_counts())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step()
        # the capture ran nothing: its launches count at each replay
        self.counts = ops.counts_since(before)
        ops.add_counts(self.counts, -1)
        self.graph, self.X = graph, None
        GRAPHS["captures"] += 1
        if self.key in _CAPTURED:
            GRAPHS["recaptures"] += 1
        _CAPTURED.add(self.key)


#: captured chunks by their static inputs (X's address, shape, dtype and
#: strides, valid_m, which masks), most recent last; :data:`GRAPH_CACHE_SIZE`
#: at most
_GRAPH_CACHE: "OrderedDict[tuple, _GraphChunks]" = OrderedDict()
GRAPH_CACHE_SIZE = 32
#: every key captured since the cache was last cleared, evicted ones too
_CAPTURED: set = set()


def _chunks_for(X, y, sm, fmask, valid_m, col=LOCAL) -> _Chunks:
    if X.device.type != "cuda" or not is_local(col):
        return _Chunks(X, y, sm, fmask, valid_m, col)
    key = (str(X.device), X.data_ptr(), tuple(X.shape), X.dtype, tuple(X.stride()),
           valid_m, sm is not None, fmask is not None)
    entry = _GRAPH_CACHE.get(key)
    if entry is None:
        entry = _GRAPH_CACHE[key] = _GraphChunks(X, y, sm, fmask, valid_m, key)
        if len(_GRAPH_CACHE) > GRAPH_CACHE_SIZE:
            _GRAPH_CACHE.popitem(last=False)
    else:
        _GRAPH_CACHE.move_to_end(key)
        entry.inputs(X, y, sm, fmask)
    return entry


def graph_cache_addresses() -> set[int]:
    """The device addresses of the matrices the cached graphs read."""
    return {k[1] for k in _GRAPH_CACHE}


def clear_graph_cache() -> None:
    """Drops every cached chunk graph and its private memory pool."""
    _GRAPH_CACHE.clear()
    _CAPTURED.clear()


def drop_graphs_reading(t: torch.Tensor) -> int:
    """Drops the cached chunk graphs whose matrix lies in ``t``'s memory
    (a buffer about to be freed: a graph reads its matrix by address), and
    forgets their keys, so capturing them again is no re-capture. Returns
    how many were dropped."""
    lo = t.data_ptr()
    hi = lo + t.numel() * t.element_size()
    gone = [k for k in _GRAPH_CACHE if k[0] == str(t.device) and lo <= k[1] < hi]
    for k in gone:
        del _GRAPH_CACHE[k]
        _CAPTURED.discard(k)
    return len(gone)


def graph_cache_info() -> list[dict]:
    """The cached chunk graphs, oldest first: shape, dtype, ``valid_m``,
    masks, and whether each is captured yet (the port of the reference's
    ``engine_cache_info``: a repeated same-shape solve must not add one)."""
    return [{"shape": k[2], "dtype": str(k[3]), "valid_m": k[5],
             "sample_mask": k[6], "feature_mask": k[7],
             "captured": e.graph is not None} for k, e in _GRAPH_CACHE.items()]


def _run_result(s: RunState, c: RunConsts) -> FistaResult:
    """The result of a finished run, copied out of the (reused) buffers."""
    return FistaResult(w=s.w.clone(), b=s.b.clone(), obj=s.obj.clone(),
                       n_iters=s.k.clone(), converged=_rel3_t(s) <= c.tol,
                       u=s.u.clone(), health=s.health.clone())


def fista_run(X, y, lam, w0, b0, inv_L, sample_mask: Optional[torch.Tensor] = None,
              feature_mask: Optional[torch.Tensor] = None, max_iters: int = 2000,
              tol: float = 1e-9, valid_m: Optional[int] = None,
              col: Collectives = LOCAL) -> FistaResult:
    """The FISTA loop with every decision on the device (reference
    ``solver.fista_run``); see the module docstring.

    Solves the problem of :func:`fista_solve` from ``(w0, b0)`` with step
    ``inv_L`` (the path's ``1 / (1.01 L)``, a number or a 0-d tensor).
    ``lam`` is a number or a 0-d tensor. ``feature_mask`` (0/1 over rows)
    freezes screened coordinates at zero (``w0`` must respect it);
    ``sample_mask`` drops columns from the loss; ``valid_m`` marks the live
    leading rows of a zero-padded buffer. The guard is always on. Returns a
    :class:`FistaResult` whose scalars are 0-d tensors on X's device: no
    host read but one ``go`` fetch a chunk of :data:`CHUNK_ITERS`
    iterations. ``n_iters`` and the objective equal :func:`fista_solve`'s
    on the same inputs. ``col``: a sharded seam, X and the vectors the
    rank's blocks (see the module docstring)."""
    c = _consts(lam, inv_L, tol, max_iters, X.device)
    s = _run_init(X, y, c, w0, b0, sample_mask, valid_m, col)
    chunks = _chunks_for(X, y, sample_mask, feature_mask, valid_m, col)
    chunks.load(s, c)
    return _run_result(chunks.run(), c)


def fista_run_dynamic(X, y, lam, w0, b0, inv_L,
                      sample_mask: Optional[torch.Tensor],
                      feature_mask: torch.Tensor, max_iters: int, tol: float,
                      screen_every: int = 50, tau: float = SAFE_TAU,
                      n_feas_iters: int = 4,
                      valid_m: Optional[int] = None,
                      col: Collectives = LOCAL,
                      telemetry: Optional[dict] = None) -> FistaResult:
    """:func:`fista_run` in segments of ``screen_every`` iterations with the
    dynamic refresh between them, all on the device (reference
    ``_dynamic_run``, the scan engines' ``dynamic=True``).

    Each refresh certifies ``(theta, delta, gap)`` from the carried margins
    (:func:`gap_theta_delta`), bounds every feature over the at-lambda
    region capped by the gap sphere (:func:`refresh_bounds`, the feature
    screen's dynamic variant), multiplies ``~(bounds < tau) | ~isfinite(
    delta)`` into the live mask, and when that moved the iterate restarts
    the state at the masked point: the margin sweep of that restart is a
    launch predicated on "moved", and the restart itself a select. A refused
    refresh keeps every feature and sets :data:`HEALTH_SCREEN_REFUSED`.
    The certificate and the screen read all rows of X (padded rows are zero
    and stay out of the mask). Host cost: the chunks' fetches and one fetch
    a segment (``FETCHES["segment"]`` counts the refreshes). Returns a
    :class:`FistaResult` as :func:`fista_run` does. ``col``: a sharded seam.
    ``telemetry`` (a dict) receives ``kept_per_segment`` and
    ``gap_per_segment`` (read in the segment's fetch) and the final
    ``feature_mask``."""
    dev = X.device
    screen_every = max(int(screen_every), 1)
    fmask = feature_mask.to(dtype=X.dtype).clone()
    c = _consts(lam, inv_L, tol, max_iters, dev)
    s = _run_init(X, y, c, w0 * fmask, b0, sample_mask, valid_m, col)
    chunks = _chunks_for(X, y, sample_mask, fmask, valid_m, col)
    chunks.load(s, c)
    go = max_iters > 0
    while go:
        # -- segment: up to screen_every iterations on the live mask
        seg_stop = torch.clamp_max(chunks.state.k + screen_every, max_iters)
        chunks.load(chunks.state, c._replace(k_stop=seg_stop))
        s = chunks.run()
        # -- refresh, on the device
        theta, delta, gap = gap_theta_delta(X, y, s.w, s.b, c.lam, sample_mask,
                                            n_feas_iters, u=s.u, col=col)
        bounds = refresh_bounds(X, y, c.lam, theta, delta, sample_mask, col)
        cert_ok = torch.isfinite(delta)
        keep = (~(bounds < tau)) | ~cert_ok
        new_mask = fmask * keep.to(fmask.dtype)
        w_m = s.w * new_mask
        moved = col.psum_model(torch.sum((s.w - w_m) * (s.w - w_m))) > 0.0
        u_m, obj_m = _margin_obj_sweep(X, y, c.lam, w_m, s.b, sample_mask,
                                       valid_m, moved.to(torch.int32), col)
        inf = torch.full_like(s.obj, np.inf)
        masked = s._replace(w=w_m, w_prev=w_m, b_prev=s.b, u=u_m, u_prev=u_m,
                            t=torch.ones_like(s.t), obj=obj_m, rel_change=inf,
                            rel_prev=inf, rel_prev2=inf)
        s = RunState(*(torch.where(moved, a, b) for a, b in zip(masked, s)))
        s = s._replace(health=torch.bitwise_or(
            s.health, torch.where(cert_ok, 0, HEALTH_SCREEN_REFUSED).to(torch.int32)))
        s = s._replace(go=_go(s, c))
        fmask = new_mask
        chunks.set_fmask(fmask)
        chunks.load(s, c)
        if telemetry is None:
            go = bool(host_fetch(s.go, "segment"))
        else:
            go, kept, gap_h = host_fetch(torch.stack([
                s.go.double(), col.psum_model(torch.sum(fmask)).double(),
                gap.double()]), "segment")
            telemetry.setdefault("kept_per_segment", []).append(int(kept))
            telemetry.setdefault("gap_per_segment", []).append(gap_h)
            go = go > 0.5
    if telemetry is not None:
        telemetry["feature_mask"] = fmask > 0.5
    return _run_result(chunks.state, c)
