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

A grid of ranks (``PathDriver(grid=..., reduce="mask")``, the launcher's
``--model/--data`` host lane, the reference launcher's ``run_path``): each
rank holds its block of X, and every step runs along the grid's seam
(``solver.Collectives``): the feature rules' programs through the scan
engines' ``path_scan._stack_bounds`` (the feature screen's full launch on a
grid that keeps the sample axis whole, else its partial mode, the
all-reduce and its finalize; ``auto``'s policy decided on rank 0), the
sample rule through ``distributed.sample_surplus_sharded`` and its
float64 verification through ``distributed.sample_violators_sharded``,
the solve through ``distributed.fista_sharded`` with the path's L (or a
sharded estimate per solve with ``exact_lipschitz``), and the certificate
through ``solver.gap_theta_delta`` (the gap floored at 4 eps |P|, where
one device certifies with ``dual.safe_theta_and_delta``). The per-feature
records are gathered once a step, so every rank returns the whole path.
:meth:`PathDriver.run` picks its lane once, ``_LocalLane`` or
``_GridLane`` (screen, solve round, certificate and records of a step),
and its loop is the same for both.

Checkpoints (``ckpt_dir``, in-core X): after every step the state of the
reference launcher (whole vectors; rank 0 writes on a grid) and the
records so far; a run with the same directory resumes after the last step
saved (see :meth:`PathDriver.run`).

Observability (``repro_torch.obs``, the reference's names): each step of
:meth:`PathDriver.run` and :meth:`PathDriver._run_chunked` records the
``path.screen``, ``path.solve``, ``path.certify`` and ``path.step`` spans
from the ``perf_counter`` stamps the driver takes for its walls (no clock
read, no device sync; with tracing off, one ``enabled()`` check), feeds
the ``path.steps``, ``path.guard_trips`` and ``path.kept`` metrics, and
returns ``extras["path_trace"]``. Under ``torch.profiler`` the four phases
are ``record_function`` regions of the same names.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..device import resolve_device
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..obs.path_trace import build_path_trace
from ..sparse.chunked import FeatureChunked
from . import distributed as D
from .dual import (
    bias_at_lambda_max,
    bias_at_lambda_max_sharded,
    lambda_max_sharded,
    safe_theta_and_delta,
    theta_at_lambda_max,
    theta_at_lambda_max_sharded,
)
from .rules import (
    AXIS_FEATURES,
    AXIS_SAMPLES,
    AutoRule,
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
    LOCAL,
    DynamicFistaResult,
    fista_solve,
    fista_solve_dynamic,
    gap_theta_delta,
    lipschitz_estimate,
)

__all__ = ["PathResult", "PathDriver", "svm_path", "default_lambda_grid"]

#: checkpoints a path keeps (the reference launcher's ``keep=2``)
CKPT_KEEP = 2


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
    #: end of each step's accepted solve; ``path_trace`` (every engine: a
    #: ``repro_torch.obs.PathTrace``); on a grid ``engine``, ``grid`` and
    #: ``backend``; with ``ckpt_dir`` ``checkpoint`` (``resumed_at``, and
    #: each save's ``seconds`` and ``bytes``)
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


def _region(name: str):
    """A ``torch.profiler.record_function`` region named as the span while a
    profiler records (``train_svm --profile``); a no-op otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return obs_trace.NOOP_SPAN


def _new_records(T: int, m: int, n: int, samples: bool, dynamic: bool) -> dict:
    """The per-step records of a host path (numpy, whole vectors), by the
    names a checkpoint stores them under (``record||<name>``)."""
    f64 = dict(dtype=np.float64)
    rec = {"weights": np.zeros((T, m), **f64), "keep_masks": np.zeros((T, m), bool)}
    for name in ("biases", "objectives", "wall", "screen_s", "solve_s", "certify_s"):
        rec[name] = np.zeros((T,), **f64)
    rec["deltas"] = np.full((T,), np.nan)
    for name in ("kept", "kept_samples", "verify_rounds", "active", "iters", "health"):
        rec[name] = np.zeros((T,), dtype=np.int64)
    if dynamic:
        rec["dynamic_keep_masks"] = np.zeros((T, m), bool)
    if samples:  # rows of the steps in ``sample_steps``
        rec["sample_masks"] = np.ones((T, n), bool)
    return rec


def _check_grid_rules(feature_rules, sample_rules) -> None:
    """On a grid each feature rule runs its rule program along the seam, and
    the sample rule is ``SampleVIRule`` (``sample_surplus_sharded``)."""
    from .rules.programs import PROGRAMS

    bad = [r.name for r in feature_rules if getattr(r, "program", None) not in PROGRAMS]
    if bad:
        raise ValueError(f"feature rules {bad} have no rule program, so no sharded "
                         "route; on a grid use feature_vi, edpp, dvi or auto")
    if any(type(r) is not SampleVIRule for r in sample_rules):
        raise ValueError("on a grid the sample rule is sample_vi "
                         "(sample_surplus_sharded)")


def _step_spans(k: int, lam: float, t0: float, screen_s: float, st0: float,
                solve_s: float, ct0: float, certify_s: float, wall_s: float,
                kept: int, iters: int, active: int, **screen_attrs) -> None:
    """A step's ``path.screen``, ``path.solve``, ``path.certify`` and
    ``path.step`` spans, from the stamps and walls the driver records
    anyway (no clock read, no device sync)."""
    obs_trace.complete("path.screen", t0, t0 + screen_s, step=k, kept=kept,
                       **screen_attrs)
    obs_trace.complete("path.solve", st0, st0 + solve_s, step=k, iters=iters)
    obs_trace.complete("path.certify", ct0, ct0 + certify_s, step=k)
    obs_trace.complete("path.step", t0, t0 + wall_s, step=k, lam=lam, kept=kept,
                       active=active)


def _anchor_state(anchor, theta_whole) -> dict:
    """A checkpoint's ``anchor_old`` keys: ``lam`` (NaN without an anchor),
    the whole ``theta`` and ``delta``."""
    if anchor is None:
        return {"lam": np.float64(np.nan), "theta": np.zeros((0,), np.float32),
                "delta": np.float32(np.nan)}
    return {"lam": np.float64(anchor[0]), "theta": theta_whole,
            "delta": np.float32(float(anchor[2]))}


@dataclass
class _Screen:
    """One step's screen: the host keep masks of the whole X (``f_mask``
    (m,), ``s_mask`` (n,)), each feature rule's ``{kept, bound_mean}``, and
    what the lane's solve and records read from it."""
    f_mask: np.ndarray
    s_mask: np.ndarray
    rules: dict
    sample_screen_kw: Optional[dict] = None  # one device: the in-solver re-screen
    fm: Optional[torch.Tensor] = None        # a grid: the rank's rows' 0/1 mask
    bounds: tuple = ()                       # a grid: the rank's rows' bounds


class _LocalLane:
    """The host path on one device: each step screens from one
    :class:`ConvexRegion`, solves the problem reduced on both axes
    (``reduce``), certifies with ``dual.safe_theta_and_delta`` and copies the
    solution to the host."""

    col = LOCAL
    writes = True        # this process publishes the checkpoints
    violators = None     # the sample rules verify on the whole X themselves
    def __init__(self, drv, X, y, feature_rules, sample_rules):
        self.drv, self.X, self.y = drv, X, y
        self.extras: dict = {}
        self.feature_rules, self.sample_rules = feature_rules, sample_rules
        self.m, self.n = X.shape
        self.cols = (0, self.n)
        # the in-solver sample re-screen: dynamic, mask mode (the solver's
        # sample mask indexes every sample) and a sample rule whose slack
        # model it borrows; gather mode screens samples between steps only
        self.dyn_sample_rule = None
        if drv.dynamic and drv.reduce == "mask":
            self.dyn_sample_rule = next(
                (r for r in sample_rules if isinstance(r, SampleVIRule)), None)

    @staticmethod
    def whole(v: torch.Tensor) -> torch.Tensor:
        """A vector over samples, whole (one device holds it whole)."""
        return v

    @staticmethod
    def block(v: np.ndarray, axis: int) -> np.ndarray:
        """This process's block of a whole vector over features (axis 0) or
        samples (axis 1)."""
        return v

    @staticmethod
    def anchor_ok(theta, delta) -> bool:
        return _anchor_ok(theta, delta)

    def screen(self, active: bool, lam_prev, lam, theta, delta, w, b, dw, db) -> _Screen:
        X, y = self.X, self.y
        sc = _Screen(np.ones((self.m,), bool), np.ones((self.n,), bool), {})
        if active:
            region = ConvexRegion.build(y, lam_prev, lam, theta, delta=delta,
                                        w1=w, b1=b, dw=dw, db=db)
            for rule in self.feature_rules:
                rb = rule.bounds(X, y, region)
                rk = rule.keep(rb).cpu().numpy()
                sc.f_mask &= rk
                sc.rules[rule.name] = {"kept": int(rk.sum()),
                                       "bound_mean": float(rb.double().mean())}
            for rule in self.sample_rules:
                sc.s_mask &= rule.keep(rule.bounds(X, y, region)).cpu().numpy()
        r = self.dyn_sample_rule
        if r is not None:
            # the rule's slack model: this step's trust radii and the secant
            # from the margins its bounds just swept
            sc.sample_screen_kw = dict(
                dynamic_samples=True, sample_dw=dw, sample_db=db,
                sample_u_prev=r._u_prev, sample_shrink_factor=r.shrink_factor,
                sample_margin_floor=r.margin_floor)
        return sc

    def solve(self, sc: _Screen, lam, s_mask, w_warm, b_warm, first: bool, L):
        """One solve round on the kept features of ``sc`` and the kept samples
        ``s_mask``: reduce X on both axes (``reduce``), solve warm-started
        from ``w_warm`` (m,) on the device and the float ``b_warm``, and
        scatter ``w`` back to a full (m,) tensor on the device. The in-solver
        sample screen runs on the first round only (a re-solve must not drop
        the violators it re-admits). Returns ``(result, w_full, live)``:
        ``live`` is the (m,) host mask of the features still live at the end
        of a dynamic solve (None without ``dynamic``)."""
        drv, X, y = self.drv, self.X, self.y
        f_idx, s_idx = np.nonzero(sc.f_mask)[0], np.nonzero(s_mask)[0]
        sample_screen_kw = sc.sample_screen_kw if first else None
        m, n = X.shape
        dev, dtype = X.device, X.dtype
        b0 = torch.as_tensor(b_warm, dtype=dtype, device=dev)
        kept, kept_s = len(f_idx), len(s_idx)

        def live(res, f_idx=None):
            if not drv.dynamic:
                return None
            fm = res.feature_mask.cpu().numpy()
            if f_idx is None:
                return fm
            out = np.zeros((m,), dtype=bool)
            out[f_idx] = fm[:len(f_idx)]
            return out

        if kept == m and kept_s == n:
            res = drv._solve(X, y, lam, w_warm, b0, L,
                             sample_screen_kw=sample_screen_kw)
            return res, res.w, live(res)
        fi = torch.from_numpy(f_idx).to(dev)
        smask = None
        if drv.reduce == "mask":
            f_mask = torch.zeros((m,), dtype=dtype, device=dev)
            f_mask[fi] = 1.0
            Xr = X * f_mask[:, None] if kept < m else X
            if kept_s < n:
                smask = torch.zeros((n,), dtype=dtype, device=dev)
                smask[torch.from_numpy(s_idx).to(dev)] = 1.0
            res = drv._solve(Xr, y, lam, w_warm * f_mask, b0, L,
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
        res = drv._solve(Xr, yr, lam, wr, b0, L, valid_m=valid_m,
                         sample_mask=smask)
        w_full = torch.zeros((m,), dtype=dtype, device=dev)
        w_full[fi] = res.w[:kept]
        return res, w_full, live(res, f_idx if kept < m else None)

    def certify(self, w, b, lam):
        theta, delta = safe_theta_and_delta(self.X, self.y, w, b, lam)
        return theta, delta, _anchor_ok(theta, delta)  # syncs

    @staticmethod
    def records(sc: _Screen, w, live):
        """``(w (m,) float64, the features kept, the live ones)`` on the host;
        fills ``sc.rules`` where the screen could not."""
        return w.double().cpu().numpy(), sc.f_mask, live


class _GridLane:
    """The host path on a grid of ranks, along its seam (see the module
    docstring): the rank holds its block of X and its columns of y, every
    step screens, solves (mask mode) and certifies through the collectives,
    and gathers the per-feature records once, so every rank records the
    whole path. Rank 0 publishes the checkpoints."""

    def __init__(self, drv, grid, X, y, feature_rules, sample_rules):
        _check_grid_rules(feature_rules, sample_rules)
        self.drv, self.grid, self.X, self.y = drv, grid, X, y
        self.feature_rules, self.sample_rules = feature_rules, sample_rules
        self.col = grid.col
        self.m, self.n = grid.shape(X)
        self.cols = (grid.j * X.shape[1], self.n)
        self.writes = grid.rank == 0
        # the float64 check of screened samples, sharded
        self.violators = D.sample_violators_sharded(
            grid, X, y, [r for r in sample_rules if r.needs_verification])
        self.extras = {"engine": "host_sharded", "backend": grid.backend,
                       "grid": {"model": grid.model, "data": grid.data}}

    def whole(self, v: torch.Tensor) -> torch.Tensor:
        return D.gather_cols(self.grid, v)

    def block(self, v: np.ndarray, axis: int) -> np.ndarray:
        return (self.grid.row_block if axis == 0 else self.grid.col_block)(v)

    @staticmethod
    def anchor_ok(theta, delta) -> bool:
        return bool(torch.isfinite(delta))

    def _feature_bounds(self, rule, lam2: float, anchor: tuple) -> torch.Tensor:
        """One feature rule's bounds of the rank's rows: its rule program
        through the scan engines' ``path_scan._stack_bounds`` (the feature
        screen's full launch, or its partial mode, the all-reduce and its
        finalize). ``dvi`` adds the VI bound of its older anchor; ``auto``
        runs its policy (:meth:`AutoRule.select`) with the kept counts
        summed over the feature axis and rank 0's decision. A rule that
        keeps an older anchor keeps ``anchor = (lam, theta, delta)`` next."""
        from .path_scan import _stack_bounds  # path_scan imports this module

        X, y, col, grid = self.X, self.y, self.col, self.grid

        def t(v):
            return torch.as_tensor(v, dtype=X.dtype, device=X.device)

        def bounds(prog, anchors):
            return _stack_bounds((prog,), X, y, None, None, t(lam2),
                                 tuple((t(a[0]), a[1], t(a[2])) for a in anchors), col)

        if isinstance(rule, AutoRule):
            b = rule.select(bounds("edpp", [anchor]), lam2,
                            lambda old: bounds("feature_vi", [old]), count=col.psum_model,
                            agree=lambda use: bool(D.rank0_value(grid, t(float(use))) > 0.5))
        elif rule.program == "dvi" and rule._anchor is not None:
            b = bounds("dvi", [rule._anchor, anchor])
        else:
            b = bounds(rule.program, [anchor])
        if hasattr(rule, "_anchor"):
            rule._anchor = anchor
        return b

    def screen(self, active: bool, lam_prev, lam, theta, delta, w, b, dw, db) -> _Screen:
        X, y, grid = self.X, self.y, self.grid
        sc = _Screen(np.ones((self.m,), bool), np.ones((self.n,), bool), {})
        keep_t = None
        if active:
            keep_t = torch.ones((X.shape[0],), dtype=torch.bool, device=X.device)
            bounds = []
            for rule in self.feature_rules:
                rb = self._feature_bounds(rule, lam, (lam_prev, theta, delta))
                keep_t &= rule.keep(rb)
                bounds.append(rb)
            sc.bounds = tuple(bounds)
            for rule in self.sample_rules:
                surplus, rule._u_prev = D.sample_surplus_sharded(
                    grid, X, y, w, b, dw, db, rule._u_prev, rule.shrink_factor,
                    rule.margin_floor)
                s_keep = D.gather_cols(grid, rule.keep(surplus).to(X.dtype))
                sc.s_mask &= s_keep.cpu().numpy() > 0.5
        sc.fm = (torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
                 if keep_t is None else keep_t.to(X.dtype))
        return sc

    def solve(self, sc: _Screen, lam, s_mask, w, b, first: bool, L):
        """One mask-mode solve on the grid (``distributed.fista_sharded``);
        ``L=None`` (exact Lipschitz) estimates on the masked X, sharded."""
        drv, X, fm = self.drv, self.X, sc.fm
        c0, n_loc = self.cols[0], X.shape[1]
        sm = (None if s_mask.all() else
              torch.from_numpy(s_mask[c0:c0 + n_loc]).to(device=X.device, dtype=X.dtype))
        if L is None:
            L = lipschitz_estimate(X, row_mask=fm, col=self.col, cols=self.cols)
        res = D.fista_sharded(
            self.grid, X, self.y, lam, max_iters=drv.max_iters, tol=drv.tol,
            w0=w * fm, b0=b, sample_mask=sm, feature_mask=fm,
            screen_every=drv.screen_every if drv.dynamic else None,
            tau=dynamic_tau(drv.rules), L=L)
        return res, res.w, (res.feature_mask if drv.dynamic else None)

    def certify(self, w, b, lam):
        theta, delta, _ = gap_theta_delta(self.X, self.y, w, b, lam, None,
                                          n_feas_iters=8, col=self.col)
        return theta, delta, self.anchor_ok(theta, delta)

    def records(self, sc: _Screen, w, live):
        """The rank's rows of everything per feature, one gather."""
        X = self.X
        rows = [w.to(X.dtype), sc.fm] + [rb.to(X.dtype) for rb in sc.bounds]
        if live is not None:
            rows.append(live.to(X.dtype))
        g = D.gather_rows(self.grid, torch.stack(rows)).cpu().numpy()
        for rule, rb in zip(self.feature_rules, g[2:2 + len(sc.bounds)]):
            rk = rule.keep(torch.from_numpy(rb)).numpy()
            sc.rules[rule.name] = {"kept": int(rk.sum()),
                                   "bound_mean": float(rb.astype(np.float64).mean())}
        return (g[0].astype(np.float64), g[1] > 0.5,
                g[-1] > 0.5 if live is not None else None)


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
    ``[X; 1^T]``; without it the path estimates one, or with
    ``exact_lipschitz`` every solve estimates its own on its reduced
    matrix. ``device`` defaults to ``"cuda"`` and raises when no GPU is
    present. ``chunk_skip`` (chunked storage only) certifies whole
    feature-row chunks dead from their cached regions before their transfer
    and skips it; ``False`` runs the full-stream twin: the same decisions
    and results, every chunk transferred.

    ``grid``: this rank's :class:`~repro_torch.core.distributed.SvmGrid`
    (``reduce="mask"`` only). :meth:`run` then takes the rank's block of X
    and its columns of y and runs each step along the grid's seam (see the
    module docstring); every rank returns the same :class:`PathResult`. A
    ``1 x 1`` grid is the single-device path.

    ``ckpt_dir``: checkpoint the path after every step (in-core X; the
    reference launcher's ``--ckpt-dir``) and resume from the latest valid
    checkpoint there (:meth:`run`); the last :data:`CKPT_KEEP` are kept.
    """

    def __init__(self, rules="feature_vi", *, reduce: str = "gather",
                 tol: float = 1e-9, max_iters: int = 4000,
                 shrink_factor: float = 1.5, max_verify_rounds: int = 3,
                 dynamic: bool = False, screen_every: int = 50,
                 L=None, exact_lipschitz: bool = False, chunk_skip: bool = True,
                 grid=None, ckpt_dir=None, device="cuda"):
        if reduce not in ("gather", "mask"):
            raise ValueError(f"reduce must be 'gather' or 'mask' ('compact' is "
                             f"a scan engine's), got {reduce!r}")
        self.rules = make_rules(rules)
        bad = [r.name for r in self.rules
               if r.axis not in (AXIS_FEATURES, AXIS_SAMPLES)]
        if bad:
            raise ValueError(f"rules must screen features or samples; got {bad}")
        if L is not None and exact_lipschitz:
            raise ValueError("pass either L= (a known bound) or exact_lipschitz=True "
                             "(an estimate per solve), not both")
        if grid is not None and grid.model * grid.data > 1 and reduce != "mask":
            raise ValueError("on a grid the host path reduces by mask (reduce='mask'): "
                             "a gather indexes the whole X")
        self.reduce = reduce
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.shrink_factor = float(shrink_factor)
        self.max_verify_rounds = int(max_verify_rounds)
        self.dynamic = bool(dynamic)
        self.screen_every = int(screen_every)
        self.L = L
        self.exact_lipschitz = bool(exact_lipschitz)
        self.chunk_skip = bool(chunk_skip)
        self.grid = grid
        self.ckpt_dir = ckpt_dir
        self.device = resolve_device(device)
        # fault-injection seam (testing/faults.py): called as
        # ``injector(k, w, b) -> (w, b)`` on the accepted solution of step k
        # (``w`` a tensor on the device, the rank's rows on a grid), BEFORE
        # it is recorded, certified and warm-starts step k+1
        self._fault_injector = None

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

    def _sharded_grid(self):
        """The grid when it has more than one rank, else None."""
        g = self.grid
        return g if g is not None and g.model * g.data > 1 else None

    def _lane(self, X, y, feature_rules, sample_rules):
        """The step's route: one device, or the grid's seam when the grid
        has more than one rank (a ``1 x 1`` grid is one device)."""
        g = self._sharded_grid()
        if g is not None:
            return _GridLane(self, g, X, y, feature_rules, sample_rules)
        return _LocalLane(self, X, y, feature_rules, sample_rules)

    def run(self, X, y, lambdas: Optional[Sequence[float]] = None,
            n_lambdas: int = 10, lam_min_ratio: float = 0.1) -> PathResult:
        """``X`` (m, n) and ``y`` (n,), numpy or tensors; moved to
        ``self.device`` once (on a grid: the rank's block and columns). ``X``
        may be a :class:`~repro_torch.sparse.FeatureChunked` instead: the
        out-of-core lane (:meth:`_run_chunked`).

        With ``ckpt_dir`` the path resumes from the latest valid checkpoint
        there, when one exists: its grid must be this run's (else
        ``ValueError``), and the steps before its ``next_k`` are taken from
        it. A checkpoint holds the reference launcher's state (``w``, ``b``,
        ``theta``, ``delta``, ``dw``, ``db``, ``k``: whole vectors, so any
        grid resumes it) and, to resume exactly, the keys
        ``anchor_old||{lam,theta,delta}`` (the anchor the last screened step
        screened from: a two-anchor rule's older anchor; ``lam`` NaN when
        none) and ``record||<name>``, the per-step records so far. Its
        manifest's ``extra`` holds ``next_k`` and ``lambdas`` (the
        reference's) and ``rule_telemetry``, ``dynamic``, ``sample_steps``
        and ``run`` (:meth:`_run_id`: a checkpoint of another configuration
        or problem raises ``ValueError`` too). A sample rule's secant history starts empty on a
        resume, as in the reference."""
        if isinstance(X, FeatureChunked):
            if self._sharded_grid() is not None:
                raise ValueError("chunked storage streams to one device; a grid runs "
                                 "in-core blocks (the reference's sharded chunks "
                                 "raise too)")
            return self._run_chunked(X, y, lambdas, n_lambdas, lam_min_ratio)
        dev = self.device
        X = torch.as_tensor(X).to(dev).contiguous()
        y = torch.as_tensor(y).to(device=dev, dtype=X.dtype)
        feature_rules = [r for r in self.rules if r.axis == AXIS_FEATURES]
        sample_rules = [r for r in self.rules if r.axis == AXIS_SAMPLES]
        lane = self._lane(X, y, feature_rules, sample_rules)
        col, m, n = lane.col, lane.m, lane.n
        for rule in self.rules:
            rule.prepare(X, y)
        # read before the first collective: no rank can publish a newer
        # checkpoint until every rank has passed it
        ckpt = self._checkpoint_open()
        y_np = lane.whole(y).cpu().numpy().astype(np.float64)

        if self.L is not None:
            L_path = torch.as_tensor(self.L, dtype=X.dtype, device=dev)
        elif self.exact_lipschitz:
            L_path = None  # every solve estimates its own
        else:
            L_path = lipschitz_estimate(X, col=col, cols=lane.cols)

        lam_max_val = float(lambda_max_sharded(X, y, col, n))
        if lambdas is None:
            lambdas = default_lambda_grid(lam_max_val, n_lambdas, lam_min_ratio)
        lambdas = _validate_grid(lambdas)
        T = len(lambdas)
        rec = _new_records(T, m, n, bool(sample_rules), self.dynamic)
        sample_steps: list[int] = []
        dyn_log: dict[int, dict] = {}
        rule_log: list[dict[str, dict]] = [{}]  # entry 0: unscreened step

        w_dev = torch.zeros((X.shape[0],), dtype=X.dtype, device=dev)
        if lambdas[0] >= lam_max_val * (1.0 - 1e-9):
            # step 0 at (or above) lam_max: the closed form (w = 0, b = mean y)
            # is exact, so delta = 0 and theta is the true dual optimum
            b_host = float(bias_at_lambda_max_sharded(y, col, n))
            theta_prev = theta_at_lambda_max_sharded(y, float(lambdas[0]), col, n)
            delta_prev = torch.zeros((), dtype=X.dtype, device=dev)
            rec["biases"][0] = b_host
            xi0 = np.maximum(0.0, 1.0 - y_np * b_host)
            rec["objectives"][0] = 0.5 * float(np.sum(xi0 * xi0))
        elif isinstance(lane, _GridLane):
            raise ValueError("on a grid the path starts at lambda_max (the closed "
                             "form); pass a grid with lambdas[0] >= lambda_max")
        else:
            # a grid starting below lam_max: solve step 0 unscreened (no
            # anchor exists yet) and certify theta via the gap bound
            t0 = time.perf_counter()
            res0 = self._solve(X, y, float(lambdas[0]), None, torch.mean(y),
                               L_path)
            w_dev, b_host = res0.w, float(res0.b)
            rec["wall"][0] = rec["solve_s"][0] = time.perf_counter() - t0
            rec["weights"][0], rec["biases"][0] = w_dev.double().cpu().numpy(), b_host
            rec["objectives"][0] = res0.obj
            rec["kept"][0] = m  # kept_samples[0] stays 0, as in the reference
            rec["keep_masks"][0] = True
            rec["active"][0] = int(np.sum(np.abs(rec["weights"][0]) > 1e-10))
            rec["iters"][0] = res0.n_iters
            rec["health"][0] |= res0.health
            if self.dynamic:
                dyn_log[0] = _dynamic_telemetry(res0)
                rec["dynamic_keep_masks"][0] = res0.feature_mask.cpu().numpy()
            theta_prev, delta_prev = safe_theta_and_delta(
                X, y, res0.w, res0.b, float(lambdas[0]))
        rec["deltas"][0] = float(delta_prev)
        lam_prev = float(lambdas[0])
        # trust-region movement (inf until one step of history exists)
        dw_pred = db_pred = float("inf")
        # the anchor the last screened step screened from (checkpointed: a
        # two-anchor rule's older anchor on a resume)
        anchor_old = old_whole = None
        theta_whole = None  # the whole theta of the last certificate
        start = 1
        run_id = None if ckpt is None else self._run_id(m, n, lam_max_val, y_np)
        if ckpt is not None and ckpt[1] is not None:
            st = self._resume(ckpt[1], lambdas, run_id, rec, rule_log, dyn_log,
                              sample_steps, lane, X.dtype)
            (start, w_dev, b_host, theta_prev, delta_prev, dw_pred, db_pred,
             anchor_old, old_whole, theta_whole) = st
            lam_prev = float(lambdas[start - 1])
            for rule in feature_rules:
                if hasattr(rule, "_anchor"):
                    rule._anchor = anchor_old
        anchor_ok = lane.anchor_ok(theta_prev, delta_prev)
        saves = {"count": 0, "seconds": [], "bytes": []}
        if ckpt is not None and theta_whole is None:
            theta_whole = lane.whole(theta_prev).cpu().numpy()

        for k in range(start, T):
            lam = float(lambdas[k])
            t0 = time.perf_counter()
            with _region("path.step"):
                # -- screening: one region, every rule -----------------------
                with _region("path.screen"):
                    if self.rules and not anchor_ok:
                        # fail-safe: the previous certificate was non-finite,
                        # so no region exists — keep every feature and sample
                        # and record the refusal
                        rec["health"][k] |= HEALTH_SCREEN_REFUSED
                    sc = lane.screen(bool(self.rules) and anchor_ok, lam_prev, lam,
                                     theta_prev, delta_prev, w_dev, b_host,
                                     dw_pred, db_pred)
                    if self.rules and anchor_ok:
                        anchor_old, old_whole = (lam_prev, theta_prev, delta_prev), theta_whole
                rec["screen_s"][k] = time.perf_counter() - t0
                rule_log.append(sc.rules)

                # -- reduce + solve + verification -----------------------------
                st0 = time.perf_counter()
                with _region("path.solve"):
                    warm = {"w": w_dev, "b": b_host, "rounds": 0}

                    def solve(mask):
                        # each verification round warm-starts from the last one
                        res, w_full, live = lane.solve(sc, lam, mask, warm["w"],
                                                       warm["b"], warm["rounds"] == 0,
                                                       L_path)
                        warm["w"], warm["b"] = w_full, float(res.b)
                        warm["rounds"] += 1
                        warm["live"] = live
                        if getattr(res, "sample_mask", None) is not None:
                            # the in-solver drops join the screened set, so
                            # the verification below covers them
                            mask &= res.sample_mask.cpu().numpy()
                        return res, w_full, res.b

                    res, w_new, b_dev, rounds = solve_with_verification(
                        solve, sample_rules, X, y, sc.s_mask,
                        max_rounds=self.max_verify_rounds, violators=lane.violators)
                b_new = float(b_dev)
                rec["solve_s"][k] = time.perf_counter() - st0
                if self._fault_injector is not None:
                    w_new, b_new = self._fault_injector(k, w_new, b_new)

                # -- certify the next anchor -----------------------------------
                ct0 = time.perf_counter()
                with _region("path.certify"):
                    theta_prev, delta_prev, anchor_ok = lane.certify(
                        w_new, torch.as_tensor(b_new, dtype=X.dtype, device=dev), lam)
                    rec["deltas"][k] = float(delta_prev)
                rec["certify_s"][k] = time.perf_counter() - ct0
                lam_prev = lam

                # -- records (whole vectors on the host) -----------------------
                w_full, f_mask, live_np = lane.records(sc, w_new, warm["live"])
                rec["kept"][k] = int(f_mask.sum())
                rec["keep_masks"][k] = f_mask
                rec["kept_samples"][k] = int(sc.s_mask.sum())
                rec["verify_rounds"][k] = rounds
                if sample_rules:
                    rec["sample_masks"][k] = sc.s_mask
                    sample_steps.append(k)
                if self.dynamic:
                    dyn_log[k] = _dynamic_telemetry(res)
                    rec["dynamic_keep_masks"][k] = live_np
                rec["health"][k] |= res.health
                # movement estimates for the next step's trust region
                # (weights[k-1] holds the previous accepted solution: at k=1
                # the closed form)
                dw_pred = self.shrink_factor * float(
                    np.linalg.norm(w_full - rec["weights"][k - 1]))
                db_pred = self.shrink_factor * abs(b_new - rec["biases"][k - 1])
                w_dev, b_host = w_new, b_new
                rec["weights"][k], rec["biases"][k] = w_full, b_new
                rec["objectives"][k] = res.obj
                rec["active"][k] = int(np.sum(np.abs(w_full) > 1e-10))
                rec["iters"][k] = res.n_iters
            rec["wall"][k] = time.perf_counter() - t0
            if obs_trace.enabled():
                _step_spans(k, lam, t0, rec["screen_s"][k], st0, rec["solve_s"][k],
                            ct0, rec["certify_s"][k], rec["wall"][k],
                            int(rec["kept"][k]), int(rec["iters"][k]),
                            int(rec["active"][k]))

            # telemetry hand-back: rules with an ``observe`` hook (AutoRule's
            # cost model) learn this step's solve wall per kept feature
            solve_s = max(rec["wall"][k] - rec["screen_s"][k], 0.0)
            for rule in feature_rules:
                obs = getattr(rule, "observe", None)
                if obs is not None:
                    obs(solve_seconds=solve_s, kept=int(rec["kept"][k]))

            if ckpt is not None:
                theta_whole = lane.whole(theta_prev).cpu().numpy()
                if lane.writes:
                    state = {"w": w_full.astype(np.float32), "b": np.float32(b_new),
                             "theta": theta_whole,
                             "delta": np.float32(float(delta_prev)),
                             "dw": np.float64(dw_pred), "db": np.float64(db_pred),
                             "k": np.int32(k), "record": rec,
                             "anchor_old": _anchor_state(anchor_old, old_whole)}
                    self._checkpoint_save(ckpt[0], k, state, lambdas, run_id,
                                          rule_log, dyn_log, sample_steps, saves)

        self._observe_run("host", rec["kept"], rec["health"])
        extras = {"lam_max": lam_max_val, "health": rec["health"],
                  "rule_telemetry": rule_log, "keep_masks": rec["keep_masks"],
                  "sample_masks": {k: rec["sample_masks"][k].copy()
                                   for k in sample_steps},
                  "solve_times": rec["solve_s"], **lane.extras}
        if self.dynamic:
            extras["dynamic"] = dyn_log
            extras["dynamic_keep_masks"] = rec["dynamic_keep_masks"]
        if ckpt is not None:
            extras["checkpoint"] = {"dir": str(self.ckpt_dir), "resumed_at": start,
                                    **saves}
        meta = {"reduce": self.reduce, "lam_max": lam_max_val}
        if "grid" in lane.extras:
            meta["grid"] = lane.extras["grid"]
        extras["path_trace"] = build_path_trace(
            "host", lambdas, rec["kept"], rec["kept_samples"], rec["active"],
            rec["iters"], rec["wall"], deltas=rec["deltas"], health=rec["health"],
            screen_s=rec["screen_s"], solve_s=rec["solve_s"],
            certify_s=rec["certify_s"], walls_observed=True, meta=meta)
        return PathResult(
            lambdas=lambdas, weights=rec["weights"], biases=rec["biases"],
            objectives=rec["objectives"], kept=rec["kept"], active=rec["active"],
            solver_iters=rec["iters"], wall_times=rec["wall"],
            screen_times=rec["screen_s"], screened=bool(self.rules),
            kept_samples=rec["kept_samples"], verify_rounds=rec["verify_rounds"],
            rules=tuple(r.name for r in self.rules), extras=extras,
        )

    @staticmethod
    def _observe_run(engine: str, kept, health):
        """Fold one run's per-step telemetry into the process metrics
        registry (``repro_torch.obs.metrics``, the reference's names): step
        counts, guard-tripped steps and the kept-per-step distribution."""
        obs_metrics.counter("path.steps").inc(int(len(kept)))
        obs_metrics.counter("path.guard_trips").inc(
            int(np.count_nonzero(np.asarray(health))))
        h = obs_metrics.histogram("path.kept")
        for v in np.asarray(kept):
            h.observe(float(v))

    # -- checkpoints ---------------------------------------------------------

    def _checkpoint_open(self):
        """``(manager, latest (flat, manifest) or None)``, or None without a
        ``ckpt_dir``."""
        if self.ckpt_dir is None:
            return None
        mgr = CheckpointManager(self.ckpt_dir, keep=CKPT_KEEP)
        step = mgr.latest()
        return mgr, (None if step is None else mgr.restore_raw(step))

    def _run_id(self, m: int, n: int, lam_max: float, y_np: np.ndarray) -> dict:
        """What a checkpoint must share with the run that resumes it: the
        options that shape the path, the problem's shape, its ``lambda_max``
        and a CRC of y (the grid of ranks is not among them: any grid
        resumes any other)."""
        return {"rules": [r.name for r in self.rules], "reduce": self.reduce,
                "dynamic": self.dynamic,
                "screen_every": self.screen_every if self.dynamic else None,
                "exact_lipschitz": self.exact_lipschitz, "tol": self.tol,
                "max_iters": self.max_iters, "shape": [int(m), int(n)],
                "lam_max": float(lam_max),
                "y_crc32": zlib.crc32(np.ascontiguousarray(y_np, np.float64).tobytes())}

    @staticmethod
    def _checkpoint_save(mgr, k, state, lambdas, run_id, rule_log, dyn_log,
                         sample_steps, saves) -> None:
        """Publish step ``k``'s checkpoint; ``saves`` counts the saves, their
        seconds and bytes on disk."""
        t0 = time.perf_counter()
        path = mgr.save(k, state, extra={
            "next_k": k + 1, "lambdas": [float(v) for v in lambdas], "run": run_id,
            "rule_telemetry": rule_log,
            "dynamic": {str(s): v for s, v in dyn_log.items()},
            "sample_steps": list(sample_steps)})
        saves["count"] += 1
        saves["seconds"].append(time.perf_counter() - t0)
        saves["bytes"].append(sum(f.stat().st_size for f in path.iterdir()))

    def _resume(self, raw, lambdas, run_id, rec, rule_log, dyn_log, sample_steps,
                lane, dtype):
        """Apply a checkpoint to this run: fills the records and logs in place
        and returns ``(start step, w, b, theta, delta, dw, db, anchor_old,
        its whole theta, whole theta)``, the vectors as this rank's blocks on
        the device (and whole ones, numpy). A checkpoint of another lambda
        grid or another run (:meth:`_run_id`; ``lambda_max`` to rel 1e-6,
        since a grid sums in another order) raises ``ValueError``."""
        flat, manifest = raw
        extra = manifest["extra"]
        saved = np.asarray(extra["lambdas"], np.float64)
        if saved.shape != lambdas.shape or not np.array_equal(saved, lambdas):
            raise ValueError(f"the checkpoint in {self.ckpt_dir} is of another lambda "
                             "grid; point ckpt_dir at an empty directory")
        theirs = dict(extra.get("run") or {})
        ours = dict(run_id)
        lam_ok = abs(theirs.pop("lam_max", np.inf) - ours.pop("lam_max")) <= (
            1e-6 * abs(run_id["lam_max"]))
        if not lam_ok or theirs != ours:
            raise ValueError(f"the checkpoint in {self.ckpt_dir} is of another run "
                             f"({extra.get('run')}, this one {run_id}); point "
                             "ckpt_dir at an empty directory")
        dev = self.device
        for name, arr in rec.items():
            key = f"record||{name}"
            if key not in flat or flat[key].shape != arr.shape:
                raise ValueError(f"the checkpoint in {self.ckpt_dir} has no record "
                                 f"{name!r} of shape {arr.shape} (another path?)")
            arr[...] = flat[key]
        rule_log[:] = extra["rule_telemetry"]
        dyn_log.update({int(s): v for s, v in extra["dynamic"].items()})
        sample_steps[:] = extra["sample_steps"]

        def t(v, axis=None):
            v = np.asarray(v) if axis is None else lane.block(np.asarray(v), axis)
            return torch.from_numpy(np.array(v)).to(device=dev, dtype=dtype)

        theta, old_theta = flat["theta"], flat["anchor_old||theta"]
        anchor_old = old_whole = None
        if np.isfinite(flat["anchor_old||lam"]):
            anchor_old = (float(flat["anchor_old||lam"]), t(old_theta, 1),
                          t(flat["anchor_old||delta"]))
            old_whole = old_theta
        return (int(extra["next_k"]), t(flat["w"], 0), float(flat["b"]),
                t(theta, 1), t(flat["delta"]), float(flat["dw"]), float(flat["db"]),
                anchor_old, old_whole, theta)

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
        The fault injector and the spans sit where :meth:`run` has them.
        ``extras``: ``lam_max``, ``storage``, ``n_chunks``, ``chunk_skip``,
        ``live_chunks`` (T,), ``stream_stats``, ``health``, ``keep_masks``
        (T, m), ``bounds`` (T, m) fp32 (each step's feature bounds, NaN
        where no feature rule ran), ``sample_masks``, ``part_times`` (per-step seconds of the
        screen, the gather and upload, the solve and the certificate),
        ``path_trace`` and with ``dynamic`` the per-step solver ``dynamic``
        reports."""
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
        if self.L is not None:
            L_path = torch.as_tensor(self.L, dtype=y.dtype, device=dev)
        else:  # exact_lipschitz: every solve estimates its own
            L_path = None if self.exact_lipschitz else lipschitz_estimate_stream(fc, dev)
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
        deltas = np.full((T,), np.nan)
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
        deltas[0] = float(delta_prev)

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
            if self._fault_injector is not None:
                w_full, b_new = self._fault_injector(k, w_full, b_new)

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
            deltas[k] = float(delta_prev)
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
            if obs_trace.enabled():
                _step_spans(k, lam, t0, parts["screen_s"][k], t1,
                            parts["gather_s"][k] + parts["solve_s"][k], t3,
                            parts["certify_s"][k], wall[k], int(kept[k]), int(iters[k]),
                            int(active[k]), live_chunks=int(live_log[k]))

        self._observe_run("chunked", kept, health)
        extras = {"lam_max": lam_max_val, "storage": "chunked",
                  "n_chunks": fc.n_chunks, "chunk_skip": self.chunk_skip,
                  "live_chunks": live_log, "health": health,
                  "keep_masks": keep_masks, "bounds": bounds_log,
                  "sample_masks": sample_masks, "part_times": parts,
                  "stream_stats": dict(fc.stats)}
        if self.dynamic:
            extras["dynamic"] = dyn_log
        extras["path_trace"] = build_path_trace(
            "chunked", lambdas, kept, kept_s, active, iters, wall, deltas=deltas,
            health=health, screen_s=parts["screen_s"],
            solve_s=parts["gather_s"] + parts["solve_s"], certify_s=parts["certify_s"],
            walls_observed=True,
            meta={"storage": "chunked", "n_chunks": fc.n_chunks,
                  "chunk_skip": self.chunk_skip, "lam_max": lam_max_val,
                  "stream_stats": dict(fc.stats)})
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

    ``exact_lipschitz`` re-estimates L on each step's reduced matrix (on
    the host engine: in every solve); by default L is estimated once per
    path.

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
    if rules is None:
        rules = [FeatureVIRule(tau=tau)] if screening else []
    driver = PathDriver(rules=rules, reduce="gather" if reduce is None else reduce,
                        tol=tol, max_iters=max_iters, dynamic=dynamic,
                        screen_every=screen_every, exact_lipschitz=exact_lipschitz,
                        chunk_skip=chunk_skip, device=device)
    return driver.run(X, y, lambdas=lambdas, n_lambdas=n_lambdas,
                      lam_min_ratio=lam_min_ratio)
