"""Streamed FISTA over :class:`FeatureChunked`: the solver's two O(mn)
sweeps as chunk-accumulated GEMVs.

Port of the reference ``sparse/solver_stream.py``. The iterate carries its
margins ``u = X^T w``, so one iteration streams X twice:

* the gradient sweep ``grad_w = -X (y xi)``, per-chunk rows;
* the margin sweep ``u_new = X^T w_new``, per-chunk partials accumulated;

and the monotone restart pays its two streams only when it fires. Each
chunk transfer is a host decision, so the loop runs on the host, and it
takes its decisions as the port's in-core host loop does
(``core/solver.fista_solve``): the objective is fetched once an
iteration (twice with a restart) and ``t``, the objective history and the
step backoff are numpy float32. The per-chunk products are ``torch.mv``
(on a CSR chunk's dense rows), as the reference leaves its chunk GEMVs to
XLA outside any Pallas kernel.

:func:`gap_theta_delta_stream` is the streamed ``dual.safe_theta_and_delta``
(the same alternating feasibility projection and radius), so the chunked
path driver certifies anchors without an in-core X.

Dynamic re-screening: ``screen_every`` cuts the solve into segments; between
them the duality gap certifies an at-lambda VI region whose bounds AND into
the live feature mask, and the live chunk set becomes the chunks that still
hold a live feature; every later sweep streams only those.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.screening import (
    SAFE_TAU,
    FeatureReductions,
    screen_bounds_from_reductions,
    shared_scalars,
)
from ..core.solver import (
    HEALTH_SCREEN_REFUSED,
    MAX_GUARD_TRIPS,
    FistaResult,
    soft_threshold,
)
from ..obs import trace as obs_trace
from .chunked import FeatureChunked, chunk_mv
from .screen_stream import fixed_reductions

__all__ = [
    "fista_solve_chunked",
    "lipschitz_estimate_stream",
    "gap_theta_delta_stream",
]

_F32 = np.float32
_EPS32 = np.finfo(np.float32).eps


def lipschitz_estimate_stream(fc: FeatureChunked, device, n_iters: int = 100,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
    """Power iteration for ``sigma_max([X; 1^T])^2``: the recurrence, the
    100 iterations and the start vector of ``core/solver.lipschitz_estimate``
    (standard normal from a CPU generator seeded 0), one stream an
    iteration (:meth:`FeatureChunked.gram_matvec`: each chunk gives its
    ``Xc^T (Xc v)``). The chunked GEMVs sum in another order, so the
    estimate agrees with the in-core one to fp32 tolerance."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v = torch.randn(fc.n, generator=generator, device=generator.device,
                    dtype=fc.torch_dtype).to(device)
    for _ in range(n_iters):
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-30)
        v = fc.gram_matvec(v) + torch.sum(v)
    return torch.linalg.vector_norm(v)


def _chunks_with_live_features(fc: FeatureChunked, fmask: np.ndarray) -> np.ndarray:
    """A chunk is live while any of its features is."""
    return np.logical_or.reduceat(fmask, fc.offsets[:-1])


def _fetch(t: torch.Tensor) -> _F32:
    return _F32(t.item())


def fista_solve_chunked(
    fc: FeatureChunked,
    y: torch.Tensor,
    lam,
    w0: Optional[torch.Tensor] = None,
    b0=None,
    max_iters: int = 2000,
    tol: float = 1e-9,
    L=None,
    sample_mask: Optional[torch.Tensor] = None,
    feature_mask=None,
    screen_every: Optional[int] = None,
    screen_tau: float = SAFE_TAU,
    report: Optional[dict] = None,
    guards: bool = True,
    iteration_hook=None,
) -> FistaResult:
    """Solve the primal over chunked storage (see the module docstring).

    ``y`` (n,) on the solve's device. Warm starts ``w0`` (m,) / ``b0``, a
    path-shared ``L`` (else :func:`lipschitz_estimate_stream`; the step is
    ``1 / (1.01 L)``), a 0/1 ``sample_mask`` dropping loss columns: the
    contract of ``core/solver.fista_solve``. ``feature_mask`` (host bool
    (m,)) pins screened features at zero and sets the live chunk set;
    ``screen_every`` re-certifies from the duality gap between segments and
    shrinks both masks; ``report`` (a dict) receives ``screens``, ``kept``
    and ``live_chunks``.

    ``guards`` (on by default, as the in-core solver's guard is always on):
    a poisoned warm start is zeroed (one trip); a non-finite objective, or
    a plain (post-restart) step that raised it beyond rounding noise, rolls
    back to the last accepted iterate, halves the step and counts a trip;
    the solve stops after :data:`~repro_torch.core.solver.MAX_GUARD_TRIPS`.
    ``iteration_hook`` (fault-injection seam) is called as ``hook(k, w, b,
    u, obj) -> None | (w, b, u, obj)`` on each candidate before the guard.
    With tracing on, the solve is a ``stream.solve`` span and each segment
    screen a ``stream.solve.screen`` instant.
    """
    t_start = time.perf_counter()
    m, n = fc.shape
    dev, dtype = y.device, y.dtype
    lam = _F32(float(lam))
    lam_t = torch.full((), float(lam), dtype=dtype, device=dev)
    sm = sample_mask
    if L is None:
        L = lipschitz_estimate_stream(fc, dev)
    L = max(_F32(float(L)) * _F32(1.01), _F32(1e-12))
    inv_L = _F32(1.0) / L

    dynamic = screen_every is not None and screen_every > 0
    fmask = (np.ones((m,), dtype=bool) if feature_mask is None
             else np.asarray(feature_mask, bool).copy())
    masked = not fmask.all()
    live = _chunks_with_live_features(fc, fmask) if (masked or dynamic) else None
    live_arg = None if (live is None or live.all()) else live
    fmask_dev = torch.from_numpy(fmask).to(device=dev, dtype=dtype)
    if dynamic:
        d_one, d_y, d_sq = fixed_reductions(fc, y)

    health = 0
    backoff = _F32(1.0)
    if w0 is None:
        w = torch.zeros((m,), dtype=dtype, device=dev)
        u = torch.zeros((n,), dtype=dtype, device=dev)
    else:
        w = w0.to(device=dev, dtype=dtype)
        if guards and not bool(torch.isfinite(w).all()):
            # w = 0 is always feasible; a poisoned coordinate would poison
            # every later iterate through the carried margins
            w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
            health += 1
        if masked:
            w = w * fmask_dev
        u = fc.rmatvec(w, live_chunks=live_arg)
    b = (torch.mean(y) if b0 is None
         else torch.as_tensor(b0, dtype=dtype, device=dev)).reshape(())
    if guards and not bool(torch.isfinite(b)):
        b = torch.zeros((), dtype=dtype, device=dev)
        health += 1

    def objective(u_a, w_a, b_a):
        xi = torch.clamp_min(1.0 - y * (u_a + b_a), 0.0)
        if sm is not None:
            xi = xi * sm
        return 0.5 * torch.sum(xi * xi) + lam_t * torch.sum(torch.abs(w_a))

    def prox_from(w_a, b_a, u_a, inv_Le):
        """One proximal step from ``(w_a, b_a)`` with known margins: two
        streams of the live chunks (dead rows are pinned at zero)."""
        xi = torch.clamp_min(1.0 - y * (u_a + b_a), 0.0)
        if sm is not None:
            xi = xi * sm
        gv = y * xi
        gw = -fc.matvec(gv, live_chunks=live_arg)
        gb = -torch.sum(gv)
        w_new = soft_threshold(w_a - float(inv_Le) * gw, float(lam * inv_Le))
        if masked:
            w_new = w_new * fmask_dev
        b_new = b_a - float(inv_Le) * gb
        u_new = fc.rmatvec(w_new, live_chunks=live_arg)
        return w_new, b_new, u_new, objective(u_new, w_new, b_new)

    obj = _fetch(objective(u, w, b))
    w_prev, b_prev, u_prev = w, b, u
    t = _F32(1.0)
    tol = _F32(tol)
    inf = _F32(np.inf)
    rel_prev = rel_prev2 = inf
    k = 0
    converged = False
    n_screens = 0
    with np.errstate(all="ignore"):
        while k < max_iters:
            inv_Le = inv_L * backoff
            t_next = _F32(0.5) * (_F32(1.0) + np.sqrt(_F32(1.0) + _F32(4.0) * t * t))
            beta = float((t - _F32(1.0)) / t_next)
            zw = w + beta * (w - w_prev)
            zb = b + beta * (b - b_prev)
            uz = u + beta * (u - u_prev)
            w_c, b_c, u_c, obj_d = prox_from(zw, zb, uz, inv_Le)
            obj_c = _fetch(obj_d)
            restarted = bool(obj_c > obj)
            if restarted:
                # monotone restart: a plain step from (w, b), margins carried
                w_c, b_c, u_c, obj_d = prox_from(w, b, u, inv_Le)
                obj_c = _fetch(obj_d)
                t_next = _F32(1.0)
            if iteration_hook is not None:
                hooked = iteration_hook(k, w_c, b_c, u_c, obj_c)
                if hooked is not None:
                    w_c, b_c, u_c, obj_c = hooked
                    obj_c = _F32(float(obj_c))
            if guards and (not np.isfinite(obj_c) or (
                    restarted and obj_c > obj + _F32(256.0) * _EPS32
                    * max(abs(obj), _F32(1.0)))):
                # the step size is invalid: roll back, halve it, restart
                # momentum
                health += 1
                backoff = backoff * _F32(0.5)
                w_prev, b_prev, u_prev, t = w, b, u, _F32(1.0)
                rel_prev = rel_prev2 = inf
                k += 1
                if (health & (HEALTH_SCREEN_REFUSED - 1)) >= MAX_GUARD_TRIPS:
                    break  # unrecoverable: poisoned operands
                continue
            # a restart iteration is not convergence evidence
            rel = inf if restarted else _F32(abs(obj - obj_c) / max(abs(obj), _F32(1e-30)))
            w_prev, b_prev, u_prev = w, b, u
            w, b, u, obj, t = w_c, b_c, u_c, obj_c, t_next
            k += 1
            # three consecutive sub-tol iterations (an fp32 tie on a momentum
            # plateau is not evidence of the optimum)
            if max(rel, rel_prev, rel_prev2) <= tol:
                converged = True
                break
            rel_prev, rel_prev2 = rel, rel_prev

            if dynamic and k % int(screen_every) == 0 and k < max_iters:
                # segment boundary: certify the reduced problem, screen the
                # at-lambda region, AND into the live masks
                theta, delta = gap_theta_delta_stream(
                    fc, y, w, b, float(lam), u=u, live_chunks=live_arg,
                    feature_mask=fmask_dev)
                if not bool(torch.isfinite(delta)):
                    # refused certificate: keep every feature this segment
                    health |= HEALTH_SCREEN_REFUSED
                    continue
                yt = y * theta
                d_theta = torch.zeros((m,), dtype=dtype, device=dev)
                for i, dv in fc.stream(dev, live_arg):
                    s, e = fc.chunk_bounds(i)
                    d_theta[s:e] = chunk_mv(dv, yt)
                red = FeatureReductions(d_theta=d_theta, d_one=d_one,
                                        d_y=d_y, d_sq=d_sq)
                sh = shared_scalars(y, float(lam), float(lam), theta, delta=delta)
                keep = (~(screen_bounds_from_reductions(red, sh) < screen_tau)
                        ).cpu().numpy()
                new_fmask = fmask & keep
                n_screens += 1
                obs_trace.instant("stream.solve.screen", iter=k,
                                  kept=int(new_fmask.sum()))
                if new_fmask.sum() < fmask.sum():
                    fmask = new_fmask
                    masked = True
                    fmask_dev = torch.from_numpy(fmask).to(device=dev, dtype=dtype)
                    live = _chunks_with_live_features(fc, fmask)
                    live_arg = None if live.all() else live
                    w = w * fmask_dev
                    u = fc.rmatvec(w, live_chunks=live_arg)
                    obj = _fetch(objective(u, w, b))
                    # a mask change invalidates the momentum
                    w_prev, b_prev, u_prev, t = w, b, u, _F32(1.0)
                    rel_prev = rel_prev2 = inf

    if obs_trace.enabled():
        obs_trace.complete("stream.solve", t_start, time.perf_counter(),
                           iters=k, converged=bool(converged),
                           screens=n_screens, kept=int(fmask.sum()))
    if report is not None:
        report.update(screens=n_screens, kept=int(fmask.sum()),
                      live_chunks=int(live.sum()) if live is not None else fc.n_chunks)
    return FistaResult(w=w, b=b, obj=float(obj), n_iters=k, converged=converged,
                       u=u, health=health)


def gap_theta_delta_stream(fc: FeatureChunked, y: torch.Tensor, w, b, lam,
                           n_feas_iters: int = 8,
                           u: Optional[torch.Tensor] = None, live_chunks=None,
                           feature_mask: Optional[torch.Tensor] = None,
                           want_corr: bool = False):
    """Streamed ``(theta1, delta)`` certificate (``dual.safe_theta_and_delta``
    over chunks). Each feasibility iteration streams the correlation sweep
    ``X (y alpha)``: ``n_feas_iters + 1`` streams; ``u`` (the solver's
    carried ``X^T w``) saves the margin stream.

    ``live_chunks`` / ``feature_mask`` certify the reduced problem: screened
    features have ``w* = 0``, so its dual-feasibility max runs over the live
    features only. ``want_corr`` also returns ``d_theta = X (y theta1)``
    from the final rescale's own sweep (zero extra streams); entries of
    skipped chunks are zero, and a live chunk's entries are valid for all
    its features, screened or not. A non-finite gap, delta or theta sets
    ``delta = inf`` (the certificate is refused)."""
    dtype, dev = y.dtype, y.device
    lam_t = torch.as_tensor(lam, dtype=dtype, device=dev)
    w = torch.as_tensor(w, dtype=dtype, device=dev)
    if u is None:
        u = fc.rmatvec(w, live_chunks=live_chunks)
    xi = torch.clamp_min(1.0 - y * (u + torch.as_tensor(b, dtype=dtype, device=dev)),
                         0.0)
    alpha = xi
    n = y.shape[0]

    def rescale(alpha):
        corr = fc.matvec(y * alpha, live_chunks=live_chunks)
        mx = torch.max(torch.abs(corr if feature_mask is None else corr * feature_mask))
        s = torch.clamp_max(lam_t / torch.clamp_min(mx, 1e-30), 1.0)
        return alpha * s, corr * s

    for _ in range(n_feas_iters):
        alpha, _ = rescale(alpha)
        alpha = torch.clamp_min(alpha - (alpha @ y) / n * y, 0.0)
    alpha, corr = rescale(alpha)

    gap = (0.5 * torch.sum(xi * xi) + lam_t * torch.sum(torch.abs(w))
           - (torch.sum(alpha) - 0.5 * torch.sum(alpha * alpha)))
    eq_resid = torch.abs(alpha @ y) / torch.sqrt(
        torch.full((), float(n), dtype=dtype, device=dev))
    delta = (torch.sqrt(2.0 * torch.clamp_min(gap, 0.0)) + 2.0 * eq_resid) / lam_t
    theta = alpha / lam_t
    cert_ok = (torch.isfinite(gap) & torch.isfinite(delta)
               & torch.isfinite(theta).all())
    delta = torch.where(cert_ok, delta, torch.full_like(delta, float("inf")))
    if want_corr:
        return theta, delta, corr / lam_t
    return theta, delta
