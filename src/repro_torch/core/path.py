"""Host-orchestrated regularization path with safe screening on both axes.

Port of the reference ``core/path.py`` host engine for dense in-core X. It
walks a decreasing grid ``lam_0 > lam_1 > ...``; at each step the previous
certified anchor ``(theta, delta)`` and the previous solution ``(w, b)``
build one :class:`~repro_torch.core.rules.base.ConvexRegion`, every feature
rule contributes a feature keep-mask and every sample rule a sample
keep-mask, a warm-started FISTA solves the reduced problem, the sample
rules verify the screened samples at the solution (violators are re-admitted
and the step re-solved, :func:`~repro_torch.core.rules.solve_with_verification`),
and the accepted solution is certified as the next anchor
(``dual.safe_theta_and_delta``).

Two reductions, on both axes:

* ``reduce="gather"`` (default) — the kept rows, then the kept columns, are
  gathered on the device (``index_select``) into power-of-two buckets,
  zero-padded; the sweeps see ``valid_m = kept`` live rows, and padded
  columns (``y = 0``) are dropped from the loss by the solver's
  ``sample_mask``. The solve costs ``kept_m x kept_n``.
* ``reduce="mask"`` — static shapes: the solve runs on ``X * f_mask`` (a
  copy of X per solve when features are screened) with a sample mask.

Trust radii for the sample rule come from observed path movement: after
each accepted step the driver predicts the next movement as
``shrink_factor * ||w_k - w_{k-1}||`` and ``shrink_factor * |b_k -
b_{k-1}|`` (inf until one step of history exists).

X never leaves the device. The host keeps the per-step records (numpy) and
the keep masks; the warm start stays on the device.

``dynamic=True`` swaps every solve for the segmented
``solver.fista_solve_dynamic``: the step's sequential screen seeds a live
feature mask that the solver tightens every ``screen_every`` iterations
from the gap-certified at-lambda region. In mask mode with a sample rule
the solver also re-screens samples from its carried margins, on the first
verification round only; those drops join the step's screened set, so the
verification covers them. Per-step, per-segment kept counts and gaps land
in ``PathResult.extras["dynamic"]``.

The Lipschitz constant is estimated once per path on the full X (or given
as ``PathDriver(L=)``) and reused by every reduced solve, verification
re-solves included: removing rows or columns never increases
``sigma_max``.

Out-of-core storage: ``X`` may be a :class:`~repro_torch.sparse.FeatureChunked`
(``PathDriver._run_chunked``). The screen streams the chunks through the
feature-screen kernel, skipping the chunks whose cached regions certify
every feature dead (``chunk_skip``); the kept rows are gathered on the host
and uploaded once a step; the certificate streams the correlation sweeps.
The device holds O(chunk + kept) of X.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..sparse.chunked import FeatureChunked
from .dual import (
    bias_at_lambda_max,
    lambda_max,
    safe_theta_and_delta,
    theta_at_lambda_max,
)
from .rules import (
    AXIS_FEATURES,
    AXIS_SAMPLES,
    ConvexRegion,
    FeatureVIRule,
    SampleVIRule,
    dynamic_tau,
    make_rules,
    solve_with_verification,
)
from .screening import SAFE_TAU, anchor_stats
from .solver import (
    HEALTH_SCREEN_REFUSED,
    DynamicFistaResult,
    fista_solve,
    fista_solve_dynamic,
    lipschitz_estimate,
)

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
    kept_samples: np.ndarray = None  # (T,) samples fed to the accepted solve
    verify_rounds: np.ndarray = None  # (T,) sample-verification re-solves
    rules: tuple = ()
    #: ``lam_max``, ``health`` (T,) guard telemetry, ``rule_telemetry``
    #: (per step, per feature rule: kept count and bound mean),
    #: ``keep_masks`` (T, m) bool, the features fed to each step's solver,
    #: ``sample_masks`` ({step: (n,) bool}, each step's accepted sample
    #: mask; empty without a sample rule) and ``solve_times`` (T,) seconds in
    #: the gathers, FISTA solves and verification rounds; with ``dynamic``
    #: also ``dynamic`` ({step: per-segment telemetry}) and
    #: ``dynamic_keep_masks`` (T, m) bool, the features still live at the
    #: end of each step's accepted solve
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


def _dynamic_telemetry(res: DynamicFistaResult) -> dict:
    """Host view of one dynamic solve's per-segment screening trace."""
    s = res.n_segments
    out = {"segments": s,
           "kept_per_segment": [int(v) for v in res.kept_per_segment[:s]],
           "gap_per_segment": [float(v) for v in res.gap_per_segment[:s]]}
    if res.kept_samples_per_segment is not None:
        out["kept_samples_per_segment"] = [
            int(v) for v in res.kept_samples_per_segment[:s]]
    return out


def _anchor_ok(theta: torch.Tensor, delta: torch.Tensor) -> bool:
    """Certificate gate: a region may only be built from a finite anchor; a
    poisoned ``(theta, delta)`` fails safe to keep-all for the next step."""
    return bool(torch.isfinite(delta).all() & torch.isfinite(theta).all())


class PathDriver:
    """Applies screening rules along the lambda path (host engine).

    ``rules`` accepts anything :func:`~repro_torch.core.rules.make_rules`
    does (``"feature_vi"``, ``"dvi"``, ``"edpp"``, ``"auto"``,
    ``"sample_vi"``, ``"composite"``, ``"sifs"``, instances, ``[]`` for the
    unscreened path). After each step, every feature rule with an
    ``observe`` method is told the step's solve seconds and kept count. ``reduce`` is ``"gather"`` or
    ``"mask"``. ``shrink_factor`` scales the observed movement into the
    next step's trust radii; ``max_verify_rounds`` bounds the re-solves
    before a step falls back to every sample. ``dynamic`` re-screens inside
    every solve each ``screen_every`` iterations (see the module
    docstring). ``L`` is a known upper bound on the Lipschitz constant of
    ``[X; 1^T]``; without it the path estimates one. ``device`` defaults to
    ``"cuda"`` and raises when no GPU is present. ``chunk_skip`` (chunked
    storage only) certifies whole feature-row chunks dead from their cached
    regions before their transfer and skips it; ``False`` runs the
    full-stream twin: the same decisions and results, every chunk
    transferred.
    """

    def __init__(self, rules="feature_vi", *, reduce: str = "gather",
                 tol: float = 1e-9, max_iters: int = 4000,
                 shrink_factor: float = 1.5, max_verify_rounds: int = 3,
                 dynamic: bool = False, screen_every: int = 50,
                 L=None, chunk_skip: bool = True, device="cuda"):
        if reduce not in ("gather", "mask"):
            raise ValueError(f"reduce must be 'gather' or 'mask' ('compact' is "
                             f"a scan engine's), got {reduce!r}")
        self.rules = make_rules(rules)
        bad = [r.name for r in self.rules
               if r.axis not in (AXIS_FEATURES, AXIS_SAMPLES)]
        if bad:
            raise ValueError(f"rules must screen features or samples; got {bad}")
        self.reduce = reduce
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.shrink_factor = float(shrink_factor)
        self.max_verify_rounds = int(max_verify_rounds)
        self.dynamic = bool(dynamic)
        self.screen_every = int(screen_every)
        self.L = L
        self.chunk_skip = bool(chunk_skip)
        self.device = resolve_device(device)

    def _solve(self, X, y, lam, w0, b0, L, valid_m=None, sample_mask=None,
               feature_mask=None, sample_screen_kw=None):
        """One solve; with ``dynamic`` the segmented solver, seeded with
        ``feature_mask`` (default: every live row)."""
        if self.dynamic:
            return fista_solve_dynamic(
                X, y, lam, w0=w0, b0=b0, max_iters=self.max_iters,
                tol=self.tol, L=L, sample_mask=sample_mask,
                feature_mask=feature_mask, screen_every=self.screen_every,
                tau=dynamic_tau(self.rules), valid_m=valid_m,
                **(sample_screen_kw or {}))
        return fista_solve(X, y, lam, w0=w0, b0=b0, max_iters=self.max_iters,
                           tol=self.tol, L=L, sample_mask=sample_mask,
                           valid_m=valid_m)

    def run(self, X, y, lambdas: Optional[Sequence[float]] = None,
            n_lambdas: int = 10, lam_min_ratio: float = 0.1) -> PathResult:
        """``X`` (m, n) and ``y`` (n,), numpy or tensors; moved to
        ``self.device`` once. ``X`` may be a
        :class:`~repro_torch.sparse.FeatureChunked` instead: the out-of-core
        lane (:meth:`_run_chunked`)."""
        if isinstance(X, FeatureChunked):
            return self._run_chunked(X, y, lambdas, n_lambdas, lam_min_ratio)
        dev = self.device
        X = torch.as_tensor(X).to(dev).contiguous()
        y = torch.as_tensor(y).to(device=dev, dtype=X.dtype)
        m, n = X.shape
        y_np = y.cpu().numpy().astype(np.float64)
        feature_rules = [r for r in self.rules if r.axis == AXIS_FEATURES]
        sample_rules = [r for r in self.rules if r.axis == AXIS_SAMPLES]
        for rule in self.rules:
            rule.prepare(X, y)

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
        kept_s = np.zeros((T,), dtype=np.int64)
        vrounds = np.zeros((T,), dtype=np.int64)
        active = np.zeros((T,), dtype=np.int64)
        iters = np.zeros((T,), dtype=np.int64)
        wall = np.zeros((T,), dtype=np.float64)
        s_times = np.zeros((T,), dtype=np.float64)
        solve_times = np.zeros((T,), dtype=np.float64)
        health = np.zeros((T,), dtype=np.int64)
        keep_masks = np.zeros((T, m), dtype=bool)
        dyn_log: dict[int, dict] = {}
        dyn_masks = np.zeros((T, m), dtype=bool)
        sample_masks: dict[int, np.ndarray] = {}
        rule_log: list[dict[str, dict]] = [{}]  # entry 0: unscreened step

        w_dev = torch.zeros((m,), dtype=X.dtype, device=dev)
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
            w_dev, b_host = res0.w, float(res0.b)
            wall[0] = solve_times[0] = time.perf_counter() - t0
            weights[0], biases[0] = w_dev.double().cpu().numpy(), b_host
            objectives[0] = res0.obj
            kept[0] = m  # kept_s[0] stays 0, as in the reference
            keep_masks[0] = True
            active[0] = int(np.sum(np.abs(weights[0]) > 1e-10))
            iters[0] = res0.n_iters
            health[0] |= res0.health
            if self.dynamic:
                dyn_log[0] = _dynamic_telemetry(res0)
                dyn_masks[0] = res0.feature_mask.cpu().numpy()
            theta_prev, delta_prev = safe_theta_and_delta(
                X, y, res0.w, res0.b, float(lambdas[0]))
        anchor_ok = _anchor_ok(theta_prev, delta_prev)
        lam_prev = float(lambdas[0])
        # trust-region movement (inf until one step of history exists)
        dw_pred = db_pred = float("inf")
        # the in-solver sample re-screen: dynamic, mask mode (the solver's
        # sample mask indexes every sample) and a sample rule whose slack
        # model it borrows; gather mode screens samples between steps only
        dyn_sample_rule = None
        if self.dynamic and self.reduce == "mask":
            dyn_sample_rule = next(
                (r for r in sample_rules if isinstance(r, SampleVIRule)), None)

        for k in range(1, T):
            lam = float(lambdas[k])
            t0 = time.perf_counter()

            # -- screening: one region, every rule ---------------------------
            f_mask = np.ones((m,), dtype=bool)
            s_mask = np.ones((n,), dtype=bool)
            step_rules: dict[str, dict] = {}
            if self.rules and not anchor_ok:
                # fail-safe: the previous certificate was non-finite, so no
                # region exists — keep every feature and sample and record
                # the refusal
                health[k] |= HEALTH_SCREEN_REFUSED
            elif self.rules:
                region = ConvexRegion.build(
                    y, lam_prev, lam, theta_prev, delta=delta_prev,
                    w1=w_dev, b1=b_host, dw=dw_pred, db=db_pred)
                for rule in feature_rules:
                    rb = rule.bounds(X, y, region)
                    rk = rule.keep(rb).cpu().numpy()
                    f_mask &= rk
                    step_rules[rule.name] = {
                        "kept": int(rk.sum()),
                        "bound_mean": float(rb.double().mean()),
                    }
                for rule in sample_rules:
                    s_mask &= rule.keep(rule.bounds(X, y, region)).cpu().numpy()
            s_times[k] = time.perf_counter() - t0
            rule_log.append(step_rules)

            # -- gather + solve + verification ---------------------------------
            st0 = time.perf_counter()
            f_idx = np.nonzero(f_mask)[0]
            kept[k] = len(f_idx)
            keep_masks[k] = f_mask
            warm = {"w": w_dev, "b": b_host, "rounds": 0}
            skw = None
            if dyn_sample_rule is not None:
                # the rule's slack model: this step's trust radii and the
                # secant from the margins its bounds just swept
                skw = dict(dynamic_samples=True, sample_dw=dw_pred,
                           sample_db=db_pred,
                           sample_u_prev=dyn_sample_rule._u_prev,
                           sample_shrink_factor=dyn_sample_rule.shrink_factor,
                           sample_margin_floor=dyn_sample_rule.margin_floor)

            def solve(mask):
                # each verification round warm-starts from the last one; the
                # in-solver sample screen runs on the first round only (a
                # re-solve must not drop the violators it re-admits)
                res, w_full, live = self._solve_reduced(
                    X, y, lam, f_idx, np.nonzero(mask)[0], warm["w"],
                    warm["b"], L_path,
                    sample_screen_kw=skw if warm["rounds"] == 0 else None)
                warm["w"], warm["b"] = w_full, float(res.b)
                warm["rounds"] += 1
                warm["live"] = live
                if getattr(res, "sample_mask", None) is not None:
                    # the in-solver drops join the screened set, so the
                    # verification below covers them
                    mask &= res.sample_mask.cpu().numpy()
                return res, w_full, res.b

            res, w_dev, b_dev, rounds = solve_with_verification(
                solve, sample_rules, X, y, s_mask,
                max_rounds=self.max_verify_rounds)
            b_new = float(b_dev)
            kept_s[k] = int(s_mask.sum())
            vrounds[k] = rounds
            if sample_rules:
                sample_masks[k] = s_mask.copy()
            if self.dynamic:
                dyn_log[k] = _dynamic_telemetry(res)
                dyn_masks[k] = warm["live"]
            health[k] |= res.health
            solve_times[k] = time.perf_counter() - st0

            # -- certify the next anchor ---------------------------------------
            theta_prev, delta_prev = safe_theta_and_delta(
                X, y, w_dev, torch.as_tensor(b_new, dtype=X.dtype, device=dev),
                lam)
            anchor_ok = _anchor_ok(theta_prev, delta_prev)  # syncs the device
            lam_prev = lam

            w_full = w_dev.double().cpu().numpy()
            # movement estimates for the next step's trust region (weights[k-1]
            # holds the previous accepted solution: at k=1 the closed form)
            dw_pred = self.shrink_factor * float(np.linalg.norm(w_full - weights[k - 1]))
            db_pred = self.shrink_factor * abs(b_new - biases[k - 1])
            b_host = b_new

            weights[k], biases[k] = w_full, b_new
            objectives[k] = res.obj
            active[k] = int(np.sum(np.abs(w_full) > 1e-10))
            iters[k] = res.n_iters
            wall[k] = time.perf_counter() - t0

            # telemetry hand-back: rules with an ``observe`` hook (AutoRule's
            # cost model) learn this step's solve wall per kept feature
            solve_s = max(wall[k] - s_times[k], 0.0)
            for rule in feature_rules:
                obs = getattr(rule, "observe", None)
                if obs is not None:
                    obs(solve_seconds=solve_s, kept=int(kept[k]))

        extras = {"lam_max": lam_max_val, "health": health,
                  "rule_telemetry": rule_log, "keep_masks": keep_masks,
                  "sample_masks": sample_masks, "solve_times": solve_times}
        if self.dynamic:
            extras["dynamic"] = dyn_log
            extras["dynamic_keep_masks"] = dyn_masks
        return PathResult(
            lambdas=lambdas, weights=weights, biases=biases,
            objectives=objectives, kept=kept, active=active,
            solver_iters=iters, wall_times=wall, screen_times=s_times,
            screened=bool(self.rules), kept_samples=kept_s,
            verify_rounds=vrounds, rules=tuple(r.name for r in self.rules),
            extras=extras,
        )

    def _solve_reduced(self, X, y, lam, f_idx, s_idx, w_warm, b_warm, L,
                       sample_screen_kw=None):
        """Reduce X on both axes (``self.reduce``), solve, and scatter ``w``
        back to a full (m,) tensor on the device.

        ``f_idx`` / ``s_idx``: host indices of the kept features / samples;
        ``w_warm`` (m,) on the device and ``b_warm`` a float warm-start the
        solve; ``sample_screen_kw`` the in-solver sample re-screen's options
        (mask mode only). Returns ``(result, w_full, live)``: ``live`` is the
        (m,) host mask of the features still live at the end of a dynamic
        solve (None without ``dynamic``)."""
        m, n = X.shape
        dev, dtype = X.device, X.dtype
        b0 = torch.as_tensor(b_warm, dtype=dtype, device=dev)
        kept, kept_s = len(f_idx), len(s_idx)

        def live(res, f_idx=None):
            if not self.dynamic:
                return None
            fm = res.feature_mask.cpu().numpy()
            if f_idx is None:
                return fm
            out = np.zeros((m,), dtype=bool)
            out[f_idx] = fm[:len(f_idx)]
            return out

        if kept == m and kept_s == n:
            res = self._solve(X, y, lam, w_warm, b0, L,
                              sample_screen_kw=sample_screen_kw)
            return res, res.w, live(res)
        fi = torch.from_numpy(f_idx).to(dev)
        smask = None
        if self.reduce == "mask":
            f_mask = torch.zeros((m,), dtype=dtype, device=dev)
            f_mask[fi] = 1.0
            Xr = X * f_mask[:, None] if kept < m else X
            if kept_s < n:
                smask = torch.zeros((n,), dtype=dtype, device=dev)
                smask[torch.from_numpy(s_idx).to(dev)] = 1.0
            res = self._solve(Xr, y, lam, w_warm * f_mask, b0, L,
                              sample_mask=smask, feature_mask=f_mask,
                              sample_screen_kw=sample_screen_kw)
            return res, res.w * f_mask, live(res)
        # gather: kept rows into a zero-padded bucket (valid_m = kept live
        # rows), then kept columns into a zero-padded bucket with y = 0 there
        Xr, yr, wr, valid_m = X, y, w_warm, None
        if kept < m:
            pad = min(_bucket(max(kept, 1)), m)
            Xr = torch.zeros((pad, n), dtype=dtype, device=dev)
            torch.index_select(X, 0, fi, out=Xr[:kept])
            wr = torch.zeros((pad,), dtype=dtype, device=dev)
            wr[:kept] = w_warm[fi]
            valid_m = kept
        if kept_s < n:
            pad_n = min(_bucket(max(kept_s, 1)), n)
            si = torch.from_numpy(s_idx).to(dev)
            Xc = torch.zeros((Xr.shape[0], pad_n), dtype=dtype, device=dev)
            torch.index_select(Xr, 1, si, out=Xc[:, :kept_s])
            Xr = Xc
            yr = torch.zeros((pad_n,), dtype=dtype, device=dev)
            yr[:kept_s] = y[si]
            smask = torch.zeros((pad_n,), dtype=dtype, device=dev)
            smask[:kept_s] = 1.0
        res = self._solve(Xr, yr, lam, wr, b0, L, valid_m=valid_m,
                          sample_mask=smask)
        w_full = torch.zeros((m,), dtype=dtype, device=dev)
        w_full[fi] = res.w[:kept]
        return res, w_full, live(res, f_idx if kept < m else None)

    # -- out-of-core lane --------------------------------------------------

    def _run_chunked(self, fc: FeatureChunked, y, lambdas=None,
                     n_lambdas: int = 10,
                     lam_min_ratio: float = 0.1) -> PathResult:
        """The screened path over :class:`~repro_torch.sparse.FeatureChunked`
        storage (reference ``PathDriver._run_chunked``).

        The recurrence of :meth:`run` around the device-memory contract:
        each step's feature screen is ``sparse.screen_step_stream`` (the
        pure-VI stack launches the feature-screen kernel once per live
        chunk; ``edpp``, ``dvi`` and ``auto``'s program evaluate from the
        streamed anchors; ``dvi`` carries history and streams every chunk);
        the kept rows are gathered on the host into a zero-padded
        power-of-two bucket on the device and solved with ``fista_solve``
        (the margin and gradient kernels, ``valid_m`` = kept); the accepted
        point is certified by ``sparse.gap_theta_delta_stream`` over the
        live chunks, whose final sweep refreshes the chunks' cache entries.

        Sample rules (``SampleVIRule`` and the stacks holding it) screen
        from the accepted solve's carried margins ``u`` and the memoized
        ``col_sq`` (no stream); the screened samples are verified at each
        solution in float64 over the support of ``w``, from the gathered
        rows (``rules/sample_vi.margins_f64``), and violators re-admitted.
        The sample axis is mask-reduced in the gathered solve.

        ``dynamic=True`` solves with the streamed segmented
        ``sparse.fista_solve_chunked`` instead of a gather.

        Raises ``ValueError`` for ``reduce="mask"``, feature rules without a
        rule program and sample rules that are not ``SampleVIRule`` s.
        ``extras``: ``lam_max``, ``storage``, ``n_chunks``, ``chunk_skip``,
        ``live_chunks`` (T,), ``stream_stats``, ``health``, ``keep_masks``
        (T, m), ``bounds`` (T, m) fp32 (each step's feature bounds, NaN
        where no feature rule ran), ``sample_masks``, ``part_times`` (per-step seconds of the
        screen, the gather and upload, the solve and the certificate) and
        with ``dynamic`` the per-step solver ``dynamic`` reports."""
        from ..sparse import (
            ChunkScreenCache,
            fista_solve_chunked,
            gap_theta_delta_stream,
            lambda_max_stream,
            lipschitz_estimate_stream,
            screen_step_stream,
        )
        from .rules.programs import PROGRAMS
        from .rules.sample_vi import margin_surplus_core

        if self.reduce != "gather":
            raise ValueError(
                "chunked storage implies gather-mode reduction (mask mode "
                f"would build the full (m, n) device matrix), got "
                f"reduce={self.reduce!r}")
        feature_rules = [r for r in self.rules if r.axis == AXIS_FEATURES]
        sample_rules = [r for r in self.rules if r.axis == AXIS_SAMPLES]
        bad = [r.name for r in feature_rules
               if getattr(r, "program", None) not in PROGRAMS]
        if bad:
            raise ValueError(
                f"chunked storage streams program-backed feature rule bounds "
                f"only ({tuple(sorted(PROGRAMS))}); feature rule(s) {bad} "
                "have no rule program: use in-core storage")
        bad_s = [r.name for r in sample_rules if not isinstance(r, SampleVIRule)]
        if bad_s:
            raise ValueError(
                "chunked storage verifies sample rules from the solver's "
                "carried margins; only SampleVIRule(-derived) rules "
                f"qualify, got {bad_s}")
        progs = tuple(dict.fromkeys(r.program for r in feature_rules))
        needs_hist = any(PROGRAMS[p].n_anchors > 1 for p in progs)
        anchor_old = None  # the step-before-last anchor of a history stack
        cache = ChunkScreenCache(fc)

        dev = self.device
        y = torch.as_tensor(y).to(device=dev, dtype=fc.torch_dtype)
        y_np = y.cpu().numpy().astype(np.float64)
        m, n = fc.shape
        tau = min((r.tau for r in feature_rules if hasattr(r, "tau")),
                  default=SAFE_TAU)
        dyn_kw = (dict(screen_every=self.screen_every,
                       screen_tau=dynamic_tau(self.rules))
                  if self.dynamic else {})
        L_path = (torch.as_tensor(self.L, dtype=y.dtype, device=dev)
                  if self.L is not None else lipschitz_estimate_stream(fc, dev))
        lam_max_val = float(lambda_max_stream(fc, y))
        if lambdas is None:
            lambdas = default_lambda_grid(lam_max_val, n_lambdas, lam_min_ratio)
        lambdas = _validate_grid(lambdas)
        T = len(lambdas)

        weights = np.zeros((T, m), dtype=np.float64)
        biases = np.zeros((T,), dtype=np.float64)
        objectives = np.zeros((T,), dtype=np.float64)
        kept = np.zeros((T,), dtype=np.int64)
        kept_s = np.zeros((T,), dtype=np.int64)
        vrounds = np.zeros((T,), dtype=np.int64)
        active = np.zeros((T,), dtype=np.int64)
        iters = np.zeros((T,), dtype=np.int64)
        wall = np.zeros((T,), dtype=np.float64)
        parts = {p: np.zeros((T,), dtype=np.float64)
                 for p in ("screen_s", "gather_s", "solve_s", "certify_s")}
        health = np.zeros((T,), dtype=np.int64)
        live_log = np.full((T,), fc.n_chunks, dtype=np.int64)
        keep_masks = np.ones((T, m), dtype=bool)
        bounds_log = np.full((T, m), np.nan, dtype=np.float32)
        sample_masks: dict[int, np.ndarray] = {}
        dyn_log: dict[int, dict] = {}

        if sample_rules:
            x_sq = fc.col_sq(dev)  # memoized on the container
            for rule in sample_rules:
                rule._u_prev = None
        dw_pred = db_pred = float("inf")
        # the accepted solution's carried margins X^T w (bias excluded)
        u_carry = torch.zeros((n,), dtype=y.dtype, device=dev)
        w_dev = torch.zeros((m,), dtype=y.dtype, device=dev)
        lam_prev = float(lambdas[0])
        if lambdas[0] >= lam_max_val * (1.0 - 1e-9):
            b_host = float(bias_at_lambda_max(y))
            theta_prev = theta_at_lambda_max(y, float(lambdas[0]))
            delta_prev = torch.zeros((), dtype=y.dtype, device=dev)
            biases[0] = b_host
            xi0 = np.maximum(0.0, 1.0 - y_np * b_host)
            objectives[0] = 0.5 * float(np.sum(xi0 * xi0))
        else:
            # a grid starting below lam_max: a streamed unscreened solve,
            # then the gap certificate (the closed form does not hold)
            t0 = time.perf_counter()
            rep0: dict = {}
            res0 = fista_solve_chunked(
                fc, y, float(lambdas[0]), max_iters=self.max_iters,
                tol=self.tol, L=L_path, report=rep0, **dyn_kw)
            w_dev, b_host, u_carry = res0.w, float(res0.b), res0.u
            weights[0], biases[0] = w_dev.double().cpu().numpy(), b_host
            objectives[0] = res0.obj
            kept[0] = m
            active[0] = int(np.sum(np.abs(weights[0]) > 1e-10))
            iters[0] = res0.n_iters
            health[0] |= res0.health
            if self.dynamic:
                dyn_log[0] = rep0
            theta_prev, delta_prev, d_th0 = gap_theta_delta_stream(
                fc, y, w_dev, res0.b, float(lambdas[0]), u=res0.u,
                want_corr=True)
            if feature_rules:
                cache.refresh(anchor_stats(y, float(lambdas[0]), theta_prev,
                                           delta_prev, d_th0))
            wall[0] = parts["solve_s"][0] = time.perf_counter() - t0
        anchor_ok = _anchor_ok(theta_prev, delta_prev)

        for k in range(1, T):
            lam = float(lambdas[k])
            t0 = time.perf_counter()
            s_mask = np.ones((n,), dtype=bool)
            f_mask = np.ones((m,), dtype=bool)
            live = np.ones((fc.n_chunks,), dtype=bool)
            if feature_rules and not anchor_ok:
                # fail-safe: no finite certificate to screen from; keep
                # every feature and stream every chunk this step
                health[k] |= HEALTH_SCREEN_REFUSED
            elif feature_rules:
                keep_t, bounds_t, anchor, live = screen_step_stream(
                    fc, y, lam_prev, lam, theta_prev, delta=delta_prev,
                    rules=progs, tau=tau, cache=cache, anchor_old=anchor_old,
                    skip=self.chunk_skip)
                if needs_hist:
                    anchor_old = anchor  # this step's fresh anchor is next's old
                f_mask = keep_t.cpu().numpy()
                bounds_log[k] = bounds_t.cpu().numpy()
                live_log[k] = int(live.sum())
            if sample_rules:
                # the margins of the accepted solution, no stream
                u1 = u_carry + b_host
                for rule in sample_rules:
                    surplus = margin_surplus_core(
                        u1, y, x_sq, dw_pred, db_pred, u_prev=rule._u_prev,
                        shrink_factor=rule.shrink_factor,
                        margin_floor=rule.margin_floor)
                    rule._u_prev = u1
                    # a non-finite surplus keeps its sample
                    s_mask &= (~(surplus >= 0.0)).cpu().numpy()
            t1 = time.perf_counter()
            parts["screen_s"][k] = t1 - t0

            f_idx = np.nonzero(f_mask)[0]
            kept[k] = len(f_idx)
            keep_masks[k] = f_mask
            fi = torch.from_numpy(f_idx).to(dev)
            if not self.dynamic:
                Xr, valid_m = self._gather_chunked(fc, f_idx, dev)
            t2 = time.perf_counter()
            parts["gather_s"][k] = t2 - t1

            warm_w, warm_b, rounds = w_dev, b_host, 0
            while True:
                smask = (None if s_mask.all() else
                         torch.from_numpy(s_mask.astype(np.float32)).to(dev))
                if self.dynamic:
                    rep: dict = {}
                    res = fista_solve_chunked(
                        fc, y, lam, w0=warm_w, b0=warm_b,
                        max_iters=self.max_iters, tol=self.tol, L=L_path,
                        sample_mask=smask, feature_mask=f_mask, report=rep,
                        **dyn_kw)
                    w_full = res.w
                    dyn_log[k] = rep
                else:
                    wr = torch.zeros((Xr.shape[0],), dtype=y.dtype, device=dev)
                    wr[:len(f_idx)] = warm_w[fi]
                    res = fista_solve(Xr, y, lam, w0=wr, b0=warm_b,
                                      max_iters=self.max_iters, tol=self.tol,
                                      L=L_path, sample_mask=smask,
                                      valid_m=valid_m)
                    w_full = torch.zeros((m,), dtype=y.dtype, device=dev)
                    w_full[fi] = res.w[:len(f_idx)]
                warm_w, warm_b = w_full, float(res.b)
                if s_mask.all() or not sample_rules:
                    break
                scr = torch.from_numpy(np.nonzero(~s_mask)[0]).to(dev)
                if self.dynamic:  # the support's rows, gathered on the host
                    supp = np.nonzero(w_full.cpu().numpy())[0]
                    Xv = torch.from_numpy(fc.gather_rows(supp)).to(dev)
                    wv = w_full[torch.from_numpy(supp).to(dev)]
                else:
                    Xv, wv = Xr, res.w
                viol = torch.cat([r.verify(Xv, y, wv, res.b, scr)
                                  for r in sample_rules]).cpu().numpy()
                if len(viol) == 0:
                    break
                rounds += 1
                if rounds >= self.max_verify_rounds:
                    s_mask[:] = True  # give up screening: an exact solve
                else:
                    s_mask[np.unique(viol)] = True
            b_new = float(res.b)
            kept_s[k] = int(s_mask.sum())
            vrounds[k] = rounds
            if sample_rules:
                sample_masks[k] = s_mask.copy()
            health[k] |= res.health
            t3 = time.perf_counter()
            parts["solve_s"][k] = t3 - t2

            # certify over the gating-live chunks (every kept feature lives
            # in one), from the carried margins; the final sweep's d_theta
            # re-anchors the live chunks' cache entries
            live_arg = None if live.all() else live
            fm = (None if f_mask.all() else
                  torch.from_numpy(f_mask.astype(np.float32)).to(dev))
            theta_prev, delta_prev, d_th = gap_theta_delta_stream(
                fc, y, w_full, res.b, lam, u=res.u, live_chunks=live_arg,
                feature_mask=fm, want_corr=True)
            anchor_ok = _anchor_ok(theta_prev, delta_prev)
            if feature_rules:
                # a poisoned anchor invalidates the entries it would refresh
                cache.refresh(anchor_stats(y, lam, theta_prev, delta_prev, d_th),
                              live=set(int(i) for i in np.nonzero(live)[0]))
            lam_prev = lam
            parts["certify_s"][k] = time.perf_counter() - t3

            w_np = w_full.double().cpu().numpy()
            dw_pred = self.shrink_factor * float(np.linalg.norm(w_np - weights[k - 1]))
            db_pred = self.shrink_factor * abs(b_new - biases[k - 1])
            w_dev, b_host, u_carry = w_full, b_new, res.u
            weights[k], biases[k] = w_np, b_new
            objectives[k] = res.obj
            active[k] = int(np.sum(np.abs(w_np) > 1e-10))
            iters[k] = res.n_iters
            wall[k] = time.perf_counter() - t0

        extras = {"lam_max": lam_max_val, "storage": "chunked",
                  "n_chunks": fc.n_chunks, "chunk_skip": self.chunk_skip,
                  "live_chunks": live_log, "health": health,
                  "keep_masks": keep_masks, "bounds": bounds_log,
                  "sample_masks": sample_masks, "part_times": parts,
                  "stream_stats": dict(fc.stats)}
        if self.dynamic:
            extras["dynamic"] = dyn_log
        return PathResult(
            lambdas=lambdas, weights=weights, biases=biases,
            objectives=objectives, kept=kept, active=active,
            solver_iters=iters, wall_times=wall, screen_times=parts["screen_s"],
            screened=bool(self.rules), kept_samples=kept_s,
            verify_rounds=vrounds, rules=tuple(r.name for r in self.rules),
            extras=extras,
        )

    @staticmethod
    def _gather_chunked(fc: FeatureChunked, f_idx: np.ndarray, dev):
        """The kept rows as a zero-padded power-of-two bucket on the device
        (``(Xr, valid_m)``, as the in-core gather makes it): gathered on the
        host, uploaded in one copy into the bucket's leading rows."""
        m, kept = fc.m, len(f_idx)
        pad = m if kept == m else min(_bucket(max(kept, 1)), m)
        Xr = torch.zeros((pad, fc.n), dtype=fc.torch_dtype, device=dev)
        if kept:
            Xr[:kept].copy_(torch.from_numpy(fc.gather_rows(f_idx)))
        return Xr, (None if kept == m else kept)


def svm_path(
    X,
    y,
    lambdas: Optional[Sequence[float]] = None,
    n_lambdas: int = 10,
    lam_min_ratio: float = 0.1,
    screening: bool = True,
    reduce: Optional[str] = None,
    tol: float = 1e-9,
    max_iters: int = 4000,
    tau: float = SAFE_TAU,
    rules=None,
    engine: str = "host",
    dynamic: bool = False,
    screen_every: int = 50,
    exact_lipschitz: bool = False,
    chunk_skip: bool = True,
    device="cuda",
):
    """Solve the L1-L2-SVM path with safe screening.

    ``screening=True`` uses the paper's feature rule (with ``tau``);
    ``rules=`` picks others (``"dvi"``, ``"edpp"``, ``"auto"``,
    ``"sample_vi"``, ``"composite"``, ``"sifs"``, a list, or instances),
    ``screening=False`` (or ``rules=[]``) disables screening.
    ``dynamic=True`` also re-screens inside each solve every
    ``screen_every`` iterations (see :class:`PathDriver`). Runs on
    ``device``, by default the GPU.

    ``engine`` picks the execution strategy:

    * ``"host"``: :class:`PathDriver`, per-step host orchestration, any rule
      mix, sample-rule verification; ``reduce`` ``"gather"`` (default) or
      ``"mask"``;
    * ``"scan"``: ``path_scan.svm_path_scan``, every solver decision on the
      device (CUDA graphs on the card), a-priori-safe feature rules only;
      ``reduce`` ``"mask"`` (default) or ``"compact"``;
    * ``"batched"``: ``path_scan.svm_path_batched``, B paths (``X (B, m,
      n)`` problems, or ``X (m, n)`` with ``lambdas (B, T)`` grids); returns
      a list of :class:`PathResult`.

    ``exact_lipschitz`` (scan engines) re-estimates L on each step's
    reduced matrix; the host engine estimates it once per path.

    ``X`` may be a :class:`~repro_torch.sparse.FeatureChunked` (host engine
    only, ``reduce="gather"``); ``chunk_skip`` then skips the transfer of
    chunks certified dead (see :class:`PathDriver`).
    """
    if engine in ("scan", "batched") and isinstance(X, FeatureChunked):
        raise ValueError(
            f"engine={engine!r} runs over an in-core X on the device; chunked "
            "storage runs on the host engine (engine='host')")
    if engine in ("scan", "batched"):
        from .path_scan import svm_path_batched, svm_path_scan  # path_scan imports us

        run = svm_path_scan if engine == "scan" else svm_path_batched
        return run(X, y, lambdas=lambdas, n_lambdas=n_lambdas,
                   lam_min_ratio=lam_min_ratio, screening=screening, tau=tau,
                   tol=tol, max_iters=max_iters, dynamic=dynamic,
                   screen_every=screen_every, exact_lipschitz=exact_lipschitz,
                   reduce="mask" if reduce is None else reduce, rules=rules,
                   device=device)
    if engine != "host":
        raise ValueError(
            f"engine must be 'host', 'scan', or 'batched', got {engine!r}")
    if exact_lipschitz:
        raise ValueError("exact_lipschitz is a scan-engine option: the host "
                         "engine estimates L once per path")
    if rules is None:
        rules = [FeatureVIRule(tau=tau)] if screening else []
    driver = PathDriver(rules=rules, reduce="gather" if reduce is None else reduce,
                        tol=tol, max_iters=max_iters, dynamic=dynamic,
                        screen_every=screen_every, chunk_skip=chunk_skip,
                        device=device)
    return driver.run(X, y, lambdas=lambdas, n_lambdas=n_lambdas,
                      lam_min_ratio=lam_min_ratio)
