"""Host-orchestrated regularization path with safe feature screening.

Port of the reference ``core/path.py`` host engine for dense in-core X and
``reduce="gather"``. It walks a decreasing grid ``lam_0 > lam_1 > ...``; at
each step the previous certified anchor ``(theta, delta)`` builds a
:class:`~repro_torch.core.rules.base.ConvexRegion`, every rule contributes a
feature keep-mask, the kept rows are gathered on the device into a
power-of-two bucket (zero-padded, so the sweeps see ``valid_m = kept``
live rows), a warm-started FISTA solves the reduced problem, and the
solution is scattered back to full coordinates and certified as the next
anchor (``dual.safe_theta_and_delta``).

X never leaves the device: the gather is an ``index_select`` on it. The
host keeps the per-step records (numpy), the warm start and the masks.

The Lipschitz constant is estimated once per path on the full X (or given
as ``PathDriver(L=)``) and reused by every reduced solve: gathering rows
never increases ``sigma_max``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .dual import (
    bias_at_lambda_max,
    lambda_max,
    safe_theta_and_delta,
    theta_at_lambda_max,
)
from .rules import AXIS_FEATURES, ConvexRegion, FeatureVIRule, make_rules
from .screening import SAFE_TAU
from .solver import HEALTH_SCREEN_REFUSED, fista_solve, lipschitz_estimate

__all__ = ["PathResult", "PathDriver", "svm_path", "default_lambda_grid"]


@dataclass
class PathResult:
    lambdas: np.ndarray            # (T,)
    weights: np.ndarray            # (T, m)
    biases: np.ndarray             # (T,)
    objectives: np.ndarray         # (T,)
    kept: np.ndarray               # (T,) kept feature count fed to the solver
    active: np.ndarray             # (T,) nnz(w) in the solution
    solver_iters: np.ndarray       # (T,)
    wall_times: np.ndarray         # (T,) seconds per step (screen + solve + certify)
    screen_times: np.ndarray       # (T,) seconds spent screening
    screened: bool = True
    rules: tuple = ()
    #: ``lam_max``, ``health`` (T,) guard telemetry, ``rule_telemetry``
    #: (per step, per rule: kept count and bound mean), ``keep_masks``
    #: (T, m) bool, the features fed to each step's solver, and
    #: ``solve_times`` (T,) seconds in the gather + FISTA solve
    extras: dict = field(default_factory=dict)


def default_lambda_grid(lam_max_val: float, n_lambdas: int = 10,
                        lam_min_ratio: float = 0.1) -> np.ndarray:
    return np.geomspace(lam_max_val, lam_max_val * lam_min_ratio, n_lambdas)


def _bucket(n: int) -> int:
    """Round up to the next power of two (min 8)."""
    b = 8
    while b < n:
        b *= 2
    return b


def _validate_grid(lambdas) -> np.ndarray:
    lambdas = np.asarray(lambdas, dtype=np.float64)
    if lambdas.size == 0:
        raise ValueError("empty lambda grid")
    if not np.all(np.isfinite(lambdas)) or np.any(lambdas <= 0):
        raise ValueError(f"lambda grid must be finite and positive: {lambdas}")
    if np.any(np.diff(lambdas) >= 0):
        raise ValueError(
            "lambda grid must be strictly decreasing (screening regions "
            f"certify theta*(lam2) only for lam2 < lam1): {lambdas}")
    return lambdas


def _anchor_ok(theta: torch.Tensor, delta: torch.Tensor) -> bool:
    """Certificate gate: a region may only be built from a finite anchor; a
    poisoned ``(theta, delta)`` fails safe to keep-all for the next step."""
    return bool(torch.isfinite(delta).all() & torch.isfinite(theta).all())


class PathDriver:
    """Applies screening rules along the lambda path (host engine, gather).

    ``rules`` accepts anything :func:`~repro_torch.core.rules.make_rules`
    does (``"feature_vi"``, instances, ``[]`` for the unscreened path).
    ``L`` is a known upper bound on the Lipschitz constant of ``[X; 1^T]``;
    without it the path estimates one. ``device`` defaults to ``"cuda"``
    and raises when no GPU is present.
    """

    def __init__(self, rules="feature_vi", *, tol: float = 1e-9,
                 max_iters: int = 4000, L=None, device="cuda"):
        self.rules = make_rules(rules)
        bad = [r.name for r in self.rules if r.axis != AXIS_FEATURES]
        if bad:
            raise ValueError(f"this port screens features only; got {bad}")
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.L = L
        self.device = resolve_device(device)

    def _solve(self, X, y, lam, w0, b0, L, valid_m=None):
        return fista_solve(X, y, lam, w0=w0, b0=b0, max_iters=self.max_iters,
                           tol=self.tol, L=L, valid_m=valid_m)

    def run(self, X, y, lambdas: Optional[Sequence[float]] = None,
            n_lambdas: int = 10, lam_min_ratio: float = 0.1) -> PathResult:
        """``X`` (m, n) and ``y`` (n,), numpy or tensors; moved to the
        driver's device once."""
        dev = self.device
        X = torch.as_tensor(X).to(dev).contiguous()
        y = torch.as_tensor(y).to(device=dev, dtype=X.dtype)
        m, n = X.shape
        y_np = y.cpu().numpy().astype(np.float64)

        if self.L is not None:
            L_path = torch.as_tensor(self.L, dtype=X.dtype, device=dev)
        else:
            L_path = lipschitz_estimate(X)

        lam_max_val = float(lambda_max(X, y))
        if lambdas is None:
            lambdas = default_lambda_grid(lam_max_val, n_lambdas, lam_min_ratio)
        lambdas = _validate_grid(lambdas)
        T = len(lambdas)

        weights = np.zeros((T, m), dtype=np.float64)
        biases = np.zeros((T,), dtype=np.float64)
        objectives = np.zeros((T,), dtype=np.float64)
        kept = np.zeros((T,), dtype=np.int64)
        active = np.zeros((T,), dtype=np.int64)
        iters = np.zeros((T,), dtype=np.int64)
        wall = np.zeros((T,), dtype=np.float64)
        s_times = np.zeros((T,), dtype=np.float64)
        solve_times = np.zeros((T,), dtype=np.float64)
        health = np.zeros((T,), dtype=np.int64)
        keep_masks = np.zeros((T, m), dtype=bool)
        rule_log: list[dict[str, dict]] = [{}]  # entry 0: unscreened step

        w_host = np.zeros((m,), dtype=np.float64)
        if lambdas[0] >= lam_max_val * (1.0 - 1e-9):
            # step 0 at (or above) lam_max: the closed form (w = 0, b = mean y)
            # is exact, so delta = 0 and theta is the true dual optimum
            b_host = float(bias_at_lambda_max(y))
            theta_prev = theta_at_lambda_max(y, float(lambdas[0]))
            delta_prev = torch.zeros((), dtype=X.dtype, device=dev)
            biases[0] = b_host
            xi0 = np.maximum(0.0, 1.0 - y_np * b_host)
            objectives[0] = 0.5 * float(np.sum(xi0 * xi0))
        else:
            # a grid starting below lam_max: solve step 0 unscreened (no
            # anchor exists yet) and certify theta via the gap bound
            t0 = time.perf_counter()
            res0 = self._solve(X, y, float(lambdas[0]), None, torch.mean(y),
                               L_path)
            w_host = res0.w.double().cpu().numpy()
            b_host = float(res0.b)
            wall[0] = solve_times[0] = time.perf_counter() - t0
            weights[0], biases[0] = w_host, b_host
            objectives[0] = res0.obj
            kept[0] = m
            keep_masks[0] = True
            active[0] = int(np.sum(np.abs(w_host) > 1e-10))
            iters[0] = res0.n_iters
            health[0] |= res0.health
            theta_prev, delta_prev = safe_theta_and_delta(
                X, y, res0.w, res0.b, float(lambdas[0]))
        anchor_ok = _anchor_ok(theta_prev, delta_prev)
        lam_prev = float(lambdas[0])

        for k in range(1, T):
            lam = float(lambdas[k])
            t0 = time.perf_counter()

            # -- screening: one region, every rule ---------------------------
            f_mask = np.ones((m,), dtype=bool)
            step_rules: dict[str, dict] = {}
            if self.rules and not anchor_ok:
                # fail-safe: the previous certificate was non-finite, so no
                # region exists — keep every feature and record the refusal
                health[k] |= HEALTH_SCREEN_REFUSED
            elif self.rules:
                region = ConvexRegion.build(y, lam_prev, lam, theta_prev,
                                            delta=delta_prev)
                for rule in self.rules:
                    rb = rule.bounds(X, y, region)
                    rk = rule.keep(rb).cpu().numpy()
                    f_mask &= rk
                    step_rules[rule.name] = {
                        "kept": int(rk.sum()),
                        "bound_mean": float(rb.double().mean()),
                    }
            s_times[k] = time.perf_counter() - t0
            rule_log.append(step_rules)

            # -- gather + solve ------------------------------------------------
            st0 = time.perf_counter()
            f_idx = np.nonzero(f_mask)[0]
            kept[k] = len(f_idx)
            keep_masks[k] = f_mask
            res, w_full = self._solve_reduced(X, y, lam, f_idx, w_host, b_host,
                                              L_path)
            b_host = float(res.b)
            w_host = w_full
            health[k] |= res.health
            solve_times[k] = time.perf_counter() - st0

            # -- certify the next anchor ---------------------------------------
            theta_prev, delta_prev = safe_theta_and_delta(
                X, y, torch.from_numpy(w_full).to(device=dev, dtype=X.dtype),
                torch.as_tensor(b_host, dtype=X.dtype, device=dev), lam)
            anchor_ok = _anchor_ok(theta_prev, delta_prev)  # syncs the device
            lam_prev = lam

            weights[k], biases[k] = w_full, b_host
            objectives[k] = res.obj
            active[k] = int(np.sum(np.abs(w_full) > 1e-10))
            iters[k] = res.n_iters
            wall[k] = time.perf_counter() - t0

        return PathResult(
            lambdas=lambdas, weights=weights, biases=biases,
            objectives=objectives, kept=kept, active=active,
            solver_iters=iters, wall_times=wall, screen_times=s_times,
            screened=bool(self.rules), rules=tuple(r.name for r in self.rules),
            extras={"lam_max": lam_max_val, "health": health,
                    "rule_telemetry": rule_log, "keep_masks": keep_masks,
                    "solve_times": solve_times},
        )

    def _solve_reduced(self, X, y, lam, f_idx, w_host, b_host, L):
        """Gather the kept rows into a bucket-sized, zero-padded buffer on
        the device, solve, and scatter ``w`` back (float64, host)."""
        m, n = X.shape
        dev, dtype = X.device, X.dtype
        b0 = torch.as_tensor(b_host, dtype=dtype, device=dev)
        kept = len(f_idx)
        if kept == m:
            w0 = torch.from_numpy(w_host).to(device=dev, dtype=dtype)
            res = self._solve(X, y, lam, w0, b0, L)
            return res, res.w.double().cpu().numpy()
        pad = min(_bucket(max(kept, 1)), m)
        idx = torch.from_numpy(f_idx).to(dev)
        Xr = torch.zeros((pad, n), dtype=dtype, device=dev)
        torch.index_select(X, 0, idx, out=Xr[:kept])
        w0_np = np.zeros((pad,), dtype=np.float64)
        w0_np[:kept] = w_host[f_idx]
        w0 = torch.from_numpy(w0_np).to(device=dev, dtype=dtype)
        res = self._solve(Xr, y, lam, w0, b0, L, valid_m=kept)
        w_full = np.zeros((m,), dtype=np.float64)
        w_full[f_idx] = res.w[:kept].double().cpu().numpy()
        return res, w_full


def svm_path(
    X,
    y,
    lambdas: Optional[Sequence[float]] = None,
    n_lambdas: int = 10,
    lam_min_ratio: float = 0.1,
    screening: bool = True,
    tol: float = 1e-9,
    max_iters: int = 4000,
    tau: float = SAFE_TAU,
    rules=None,
    engine: str = "host",
    device="cuda",
) -> PathResult:
    """Solve the L1-L2-SVM path with safe feature screening.

    ``screening=True`` uses the paper's feature rule (with ``tau``);
    ``rules=`` picks others, ``screening=False`` (or ``rules=[]``) disables
    screening. Only the host engine is ported. Runs on ``device``, by
    default the GPU.
    """
    if engine != "host":
        raise ValueError(f"this port runs engine='host' only, got {engine!r}")
    if rules is None:
        rules = [FeatureVIRule(tau=tau)] if screening else []
    driver = PathDriver(rules=rules, tol=tol, max_iters=max_iters,
                        device=device)
    return driver.run(X, y, lambdas=lambdas, n_lambdas=n_lambdas,
                      lam_min_ratio=lam_min_ratio)
