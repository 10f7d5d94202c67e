"""On-device path engines: the regularization path with every FISTA decision
taken on the device (``engine="scan"`` and ``engine="batched"``).

Port of the reference ``core/path_scan.py``. The reference runs the whole
path as one jitted ``lax.scan`` with no host sync between the first
dispatch and the final transfer. Here the lambda grid is walked by a host
loop over device tensors whose steps are those of the reference's scan
body:

* **screen** from the carried anchor ``(lam_prev, theta, delta)`` with the
  feature-screen kernel: its VI mode for ``feature_vi``, its EDPP mode for
  ``edpp`` (and ``auto``, which ``resolve_programs`` maps to ``edpp``), two
  VI launches and a NaN-propagating min for ``dvi``, whose carry grows the
  step-before-last anchor (seeded with the initial one). The region's
  scalars come from the anchor's on the device
  (``screening.shared_scalars_from_stats`` / ``edpp_scalars_from_stats``).
  The reference computes this screen in XLA from the hoisted ``X @ y``,
  ``X @ 1`` and ``||f||^2`` plus a per-step ``X @ (y * theta)``; the
  kernel's one read of X a step replaces all four. Keeps are NaN-safe,
  ``~(bounds < tau)``, and a non-finite anchor keeps every feature and sets
  ``HEALTH_SCREEN_REFUSED``. Features re-entering the keep set against the
  carried mask are counted (``extras["resurrected"]``);
* **solve** with ``solver.fista_run`` (or ``fista_run_dynamic``), whose
  restart, guard and stop rule are decided on the device and whose chunks
  replay as CUDA graphs on the card. ``reduce="mask"`` solves on the full X
  with the keep mask frozen in; ``reduce="compact"`` gathers the kept rows
  (``torch.cumsum`` ranks scattered into the row index of each slot, then
  ``index_select``) into a zero-padded buffer of the smallest
  :func:`compact_caps` bucket that holds them, and falls back to mask mode
  when none does;
* **certify** the solution with ``solver.gap_theta_delta`` (8 feasibility
  rounds), reusing the solver's margins: the next step's anchor.

Host fetches. The reference takes none. This port takes one a step: the
compact buffer's capacity picks the graph, so the kept count must be known
on the host (for batched paths, all elements' counts in one fetch); and
the solver fetches its ``go`` flag once a chunk of ``solver.CHUNK_ITERS``
iterations. ``extras["host_fetches"]`` counts them by kind, and
``extras["graphs"]`` the chunk graphs captured and replayed.

Memory held between calls. The captured graphs stay cached
(:func:`engine_cache_info`, at most ``solver.GRAPH_CACHE_SIZE``), each with
its private memory pool, and so does each compact capacity's zero-padded
buffer that a cached graph reads (``cap x n`` of X's dtype: on the
full-width feature path, 50,000 x 10,000 fp32, the 2,048- to 16,384-row
buffers hold up to 1.2 GB). A later same-shape path replays them without a
capture; :func:`clear_engine_cache` frees them all.

``valid_m`` in compact mode. The margin and gradient kernels plan their
work on the host from a live-row count; inside a graph keyed by the
capacity that count is the capacity itself, which is exact because the
buffer's rows past the kept ones are zero (and frozen at zero by the
solver's feature mask). The sweeps then read ``cap - kept`` zero rows a
call, at most ``cap / 2`` of them except in the smallest bucket: on the
full-width feature path 2,048-row buffers hold 8 and 11 features. Reading
the count from the device would need the kernels to split their rows on
the device (ROADMAP queue 2).

:func:`svm_path_batched` runs B paths at once, one dataset with B grids
(``X (m, n)``, ``lambdas (B, T)``) or B problems (``X (B, m, n)``): each
step screens every element, picks ONE shared compact capacity from the
batch-max kept count over the live elements (one overflowing element
demotes the step to mask mode), then solves and certifies the elements one
after another (:func:`_batched_path_step`, which the path server,
``launch/path_server.py``, drives with a 0/1 sample mask over its padded
slots and one predicted capacity). A sweep that reads a shared X once for
B right-hand sides is later kernel work.

The Lipschitz constant is estimated once per path on the full X
(``exact_lipschitz=True``: again on each step's reduced matrix). Rule
specs are resolved at dispatch (``rules/programs.resolve_programs``):
sample rules and ``sifs`` raise before any work. The port leaves out the
reference's ``use_pallas=`` and ``guards=``: the kernels always run on the
card and the guard is always on.

Observability (``repro_torch.obs``, the reference's names): each engine
records its ``scan.dispatch`` / ``batched.dispatch`` /
``scan_sharded.dispatch`` span from the stamps it takes for its wall, feeds
the ``path.*`` metrics (``PathDriver._observe_run``) and returns
``extras["path_trace"]``, built after the path from its outputs: a step's
wall is the uniform share of the path's (the steps overlap on the device,
``walls_observed=False``) and its ``solve_s`` the solve seconds the host
loop stamps. With tracing on, the trace's per-step spans are synthesized
into the tracer (``PathTrace.emit_to_tracer``). None of it syncs the
device.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import solver
from .dual import (
    bias_at_lambda_max,
    bias_at_lambda_max_sharded,
    lambda_max,
    lambda_max_sharded,
    theta_at_lambda_max,
    theta_at_lambda_max_sharded,
)
from ..obs import trace as obs_trace
from ..obs.path_trace import build_path_trace
from .path import PathDriver, PathResult, _validate_grid, default_lambda_grid
from .rules.programs import PROGRAMS, resolve_programs, stack_needs_history
from .screening import SAFE_TAU, edpp_scalars_from_stats, shared_scalars_from_stats
from .solver import (
    HEALTH_SCREEN_REFUSED,
    LOCAL,
    Collectives,
    _identity,
    fista_run,
    fista_run_dynamic,
    gap_theta_delta,
    host_fetch,
    lipschitz_estimate,
    region_stats,
    seam_screen_bounds,
)

__all__ = [
    "svm_path_scan",
    "svm_path_scan_sharded",
    "svm_path_batched",
    "ScanPathOutputs",
    "compact_caps",
    "compact_caps_batched",
    "engine_cache_info",
    "clear_engine_cache",
]


class ScanPathOutputs(NamedTuple):
    """Stacked per-step outputs of the engines (leading T, or (B, T)), as
    device tensors until :func:`_to_path_result` reads them."""

    w: torch.Tensor            # (T, m)
    b: torch.Tensor            # (T,)
    obj: torch.Tensor          # (T,)
    kept: torch.Tensor         # (T,) int32: live features fed to the solver
    active: torch.Tensor       # (T,) int32: nnz(w) at the solution
    n_iters: torch.Tensor      # (T,) int32
    converged: torch.Tensor    # (T,) bool
    gap: torch.Tensor          # (T,) duality gap certified at the accepted point
    delta: torch.Tensor        # (T,) theta radius anchoring the next step
    fmask: torch.Tensor        # (T, m) bool: the certified keep mask per step
    cap: torch.Tensor          # (T,) int32: compact capacity (m = mask mode)
    resurrected: torch.Tensor  # (T,) int32: keeps the previous mask had dropped
    # (T,) int32 guard telemetry: low bits count solver rollbacks;
    # HEALTH_SCREEN_REFUSED flags a step screened from a refused anchor
    health: torch.Tensor


def compact_caps(m: int, max_buckets: int = 4, min_cap: int = 32) -> tuple:
    """Bucket schedule of the compacted active-set buffer: powers of two
    from ``min_cap`` up to ``m // 2`` (past that the gather costs more than
    it saves, and mask mode runs), the largest ``max_buckets`` of them.
    Empty for small ``m``: compact mode is then mask mode."""
    caps = []
    c = min_cap
    while c <= m // 2:
        caps.append(c)
        c *= 2
    return tuple(caps[-max_buckets:])


def compact_caps_batched(m: int, kept_counts=None, max_buckets: int = 4,
                         min_cap: int = 32):
    """The shared capacity of a batch of compacting path elements: with
    ``kept_counts``, the smallest bucket of :func:`compact_caps` holding the
    largest count (``m`` means the mask-mode overflow); without, the
    ladder itself."""
    caps = compact_caps(m, max_buckets=max_buckets, min_cap=min_cap)
    if kept_counts is None:
        return caps
    ks = np.asarray(kept_counts)
    k = int(ks.max()) if ks.size else 0
    for c in caps:
        if k <= c:
            return int(c)
    return int(m)


def _validate_reduce(reduce: str) -> str:
    if reduce not in ("mask", "compact"):
        raise ValueError(
            "scan-engine reduce must be 'mask' or 'compact' (gather is the "
            f"host engine's), got {reduce!r}")
    return reduce


def _static_opts(max_iters, screening, dynamic, screen_every, exact_lipschitz,
                 reduce="mask", rules=None) -> tuple:
    """The engine's options as ``(name, value)`` pairs. The rule spec is
    resolved here, at dispatch: a spec with no program (sample rules,
    ``sifs``) raises before any work, and ``rules="none"`` turns screening
    off."""
    progs = resolve_programs(rules, screening=bool(screening))
    return (
        ("max_iters", int(max_iters)),
        ("screening", bool(progs)),
        ("dynamic", bool(dynamic)),
        ("screen_every", max(int(screen_every), 1)),
        ("exact_lipschitz", bool(exact_lipschitz)),
        ("reduce", _validate_reduce(reduce)),
        ("rules", progs),
    )


def _batched_statics(X, y, sm, shared_x: bool) -> tuple:
    """The theta-independent scalars of each element's region: ``(y^T s,
    sum(s))``, the label sum and the live-sample count over the 0/1 sample
    mask ``s`` (all samples without one), each 0-d when ``shared_x`` and
    (B,) otherwise. The reference also hoists the three per-feature
    reductions ``X @ (y s)``, ``X @ s`` and ``(X * X) @ s``: here the
    feature-screen kernel takes them from its one read of X a step (with
    ``s`` as its sample weights)."""
    if sm is None:
        one_y = torch.sum(y, dim=-1)
        n_tot = torch.full_like(one_y, float(y.shape[-1]))
    else:
        one_y, n_tot = torch.sum(y * sm, dim=-1), torch.sum(sm, dim=-1)
    return one_y, n_tot


# -- the screen ------------------------------------------------------------------


def _region_stats(y, statics, lam2, anchor, col=LOCAL) -> dict:
    """The arguments of ``shared_scalars_from_stats`` for the region
    anchored at ``anchor = (lam, theta, delta)`` targeting ``lam2`` (the
    theta statistics summed over the grid's samples under ``col``)."""
    lam_a, theta, delta = anchor
    return dict(lam1=lam_a, lam2=lam2, delta=delta,
                **region_stats(y, theta, col, statics=statics))


def _vi_bounds(X, y, sm, statics, lam2, anchor, col=LOCAL):
    """The VI bound of one anchor: one launch of the feature screen (its
    weighted instantiation under a sample mask; sharded over samples, its
    partial mode, the all-reduce and its finalize)."""
    sh = shared_scalars_from_stats(**_region_stats(y, statics, lam2, anchor, col))
    return seam_screen_bounds(X, y, anchor[1], sh, col, weights=sm)


def _edpp_bounds(X, y, sm, statics, lam2, anchor, col=LOCAL):
    """The EDPP bound of one anchor (min-composed with its VI bound): one
    launch of the feature screen's EDPP mode (its weighted instantiation
    under a sample mask; sharded over samples: the partial mode and the
    EDPP finalize)."""
    kw = _region_stats(y, statics, lam2, anchor, col)
    return seam_screen_bounds(X, y, anchor[1], shared_scalars_from_stats(**kw), col,
                              weights=sm, edpp=edpp_scalars_from_stats(**kw))


def _stack_bounds(progs, X, y, sm, statics, lam2, anchors, col=LOCAL):
    """Elementwise min of the stack's bounds (the reference's
    ``stack_bounds`` over its programs), each program from the kernel.
    ``anchors`` are oldest to latest; a two-anchor program (``dvi``) takes
    the min with the older anchor's VI bound while that anchor's lambda
    exceeds ``lam2``. ``col``: a sharded seam (X the rank's block; the
    statics and anchors' lambdas global)."""
    memo = {}

    def vi(i):
        if i not in memo:
            memo[i] = _vi_bounds(X, y, sm, statics, lam2, anchors[i], col)
        return memo[i]

    out = None
    for name in progs:
        if name == "feature_vi":
            b = vi(-1)
        elif name == "edpp":
            b = _edpp_bounds(X, y, sm, statics, lam2, anchors[-1], col)
        elif name == "dvi":
            b = vi(-1)
            if len(anchors) >= 2:
                below = anchors[0][0] > lam2
                b = torch.where(below, torch.minimum(b, vi(0)), b)
        else:  # resolve_programs admits only registered programs
            raise ValueError(f"no kernel route for rule program {name!r}")
        out = b if out is None else torch.minimum(out, b)
    return out


# -- the compact buffer ----------------------------------------------------------

#: the zero-padded compaction buffers, one per (device, cap, n, dtype): a
#: buffer's address is part of its chunk graph's cache key, so one buffer
#: serves every step, element and call of that shape. A buffer lives while a
#: cached graph reads it: the next new buffer frees those that the graph
#: cache's LRU eviction left unread, and :func:`clear_engine_cache` frees all
_COMPACT_BUFFERS: dict = {}


def _compact_buffer(X: torch.Tensor, cap: int) -> torch.Tensor:
    key = (str(X.device), cap, X.shape[-1], X.dtype)
    buf = _COMPACT_BUFFERS.get(key)
    if buf is None:
        read = solver.graph_cache_addresses()
        for k in [k for k, b in _COMPACT_BUFFERS.items() if b.data_ptr() not in read]:
            del _COMPACT_BUFFERS[k]
        buf = _COMPACT_BUFFERS[key] = torch.zeros((cap, X.shape[-1]), dtype=X.dtype,
                                                  device=X.device)
    return buf


def clear_engine_cache() -> dict:
    """Frees the engines' warm cache: the captured chunk graphs (each with
    its private memory pool) and the compaction buffers. The next path
    captures anew. Returns what was dropped: graphs, buffers and the
    buffers' bytes."""
    dropped = {"graphs": len(solver.graph_cache_info()),
               "buffers": len(_COMPACT_BUFFERS),
               "buffer_bytes": sum(b.numel() * b.element_size()
                                   for b in _COMPACT_BUFFERS.values())}
    solver.clear_graph_cache()
    _COMPACT_BUFFERS.clear()
    return dropped


def _compact_rows(fmask: torch.Tensor, cap: int) -> torch.Tensor:
    """``sel`` (cap,): slot ``r`` holds the index of the ``r``-th kept row
    (``m`` past the last), from a cumsum of the keep mask scattered into the
    slots; rows that rank past ``cap`` are dropped, as the reference's
    ``mode="drop"``."""
    m = fmask.shape[0]
    keep = fmask > 0.5
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    slot = torch.where(keep & (pos < cap), pos, cap)
    sel = torch.full((cap + 1,), m, dtype=torch.int64, device=fmask.device)
    sel.scatter_(0, slot, torch.arange(m, device=fmask.device))
    return sel[:cap]


# -- one step ----------------------------------------------------------------------


def _inv_L(L: torch.Tensor) -> torch.Tensor:
    """The step ``1 / max(1.01 L, 1e-12)`` in fp32, on L's device."""
    return 1.0 / torch.clamp_min(L.to(torch.float32) * 1.01, 1e-12)


def _solve(Xs, ye, sme, lam, w0, b0, fms, inv_L, vm, o):
    if o["dynamic"]:
        return fista_run_dynamic(Xs, ye, lam, w0, b0, inv_L, sme, fms,
                                 o["max_iters"], o["tol"], o["screen_every"],
                                 o["tau"], 4, valid_m=vm)
    return fista_run(Xs, ye, lam, w0, b0, inv_L, sme, fms, o["max_iters"],
                     o["tol"], valid_m=vm, col=o["col"])


def _solve_element(Xe, ye, sme, lam, inv_L, w, b, fmask, cap, kept, o):
    """One element's solve in the step's reduction: mask mode (``cap`` =
    m) on the full X with ``fmask`` frozen in, else compact into the
    ``cap``-row buffer. Returns ``(w over all m rows, result)``."""
    m = Xe.shape[0]
    if cap == m:
        inv = (_inv_L(lipschitz_estimate(Xe, row_mask=fmask, col=o["col"],
                                         cols=o["cols"]))
               if o["exact_lipschitz"] else inv_L)
        res = _solve(Xe, ye, sme, lam, w * fmask, b, fmask, inv, None, o)
        return res.w, res
    buf = _compact_buffer(Xe, cap)
    live = min(kept, cap)
    idx = _compact_rows(fmask, cap)[:live]
    torch.index_select(Xe, 0, idx, out=buf[:live])
    buf[live:].zero_()
    w0 = torch.zeros((cap,), dtype=w.dtype, device=w.device)
    w0[:live] = w[idx]
    valid = torch.zeros((cap,), dtype=fmask.dtype, device=fmask.device)
    valid[:live] = 1.0
    inv = _inv_L(lipschitz_estimate(buf)) if o["exact_lipschitz"] else inv_L
    res = _solve(buf, ye, sme, lam, w0, b, valid, inv, cap, o)
    w_full = torch.zeros((m,), dtype=w.dtype, device=w.device)
    w_full.index_copy_(0, idx, res.w[:live])
    return w_full, res


def _batched_path_step(X, y, sm, statics, inv_L, tau, tol, carry, lam, act, *,
                       caps: tuple, shared_x: bool, max_iters: int,
                       screening: bool, dynamic: bool, screen_every: int,
                       exact_lipschitz: bool, rules: tuple = ("feature_vi",),
                       n_feas_iters: int = 8, telemetry: Optional[dict] = None,
                       col: Collectives = LOCAL, cols: Optional[tuple] = None):
    """One batched lambda step: screen every element, pick one shared
    compact capacity, solve and certify every element (the reference's
    ``_batched_path_step``; a single path is B = 1).

    Shapes: ``lam`` and ``inv_L`` are (B,) tensors and ``act`` (the live
    elements) B bools on the host; the carry's leaves lead with B; ``X``,
    ``y``, ``sm`` and ``statics`` (:func:`_batched_statics`) are shared
    (``shared_x``) or lead with B. ``sm`` is None or a 0/1 live-sample mask: it reaches the
    feature screen as its sample weights and the solver as its sample mask,
    so a padded element solves its unpadded problem. One host fetch: every
    element's kept count (the shared capacity is the smallest of ``caps``,
    ascending, holding the batch-max over the live ones: the whole
    :func:`compact_caps` ladder for the engines, the one predicted capacity
    for the path server; ``()`` is mask mode). An element that is not live
    (an empty server slot) is neither screened, solved nor certified.
    ``telemetry`` (a dict) receives each element's solve seconds under
    ``"solve_seconds"``. ``col`` (with ``cols``, the rank's first column
    and the whole n): a sharded seam, X the rank's block, the counts summed
    over the feature axis. Returns ``(carry', out)``, every
    :class:`ScanPathOutputs` leaf leading with B."""
    m, n = X.shape[-2], X.shape[-1]
    B = lam.shape[0]
    progs = tuple(rules) if screening else ()
    hist = stack_needs_history(tuple(PROGRAMS[p] for p in progs))
    if hist:
        (w, b, theta, delta, lam_prev, fmask_prev,
         lam_old, theta_old, delta_old) = carry
    else:
        w, b, theta, delta, lam_prev, fmask_prev = carry

    def elem(e):
        if shared_x:
            return X, y, sm, statics
        return X[e], y[e], None if sm is None else sm[e], (statics[0][e], statics[1][e])

    act_h = [bool(a) for a in act]
    # -- screen: every live element from its carried anchor(s)
    keeps, oks = [], []
    for e in range(B):
        Xe, ye, sme, st = elem(e)
        ok = torch.isfinite(delta[e])
        if hist:
            ok = ok & torch.isfinite(delta_old[e])
        if progs and act_h[e]:
            anchors = ((lam_prev[e], theta[e], delta[e]),)
            if hist:
                anchors = ((lam_old[e], theta_old[e], delta_old[e]),) + anchors
            bounds = _stack_bounds(progs, Xe, ye, sme, st, lam[e], anchors, col)
            keeps.append((~(bounds < tau)) | ~ok)
        else:
            keeps.append(torch.ones((m,), dtype=torch.bool, device=X.device))
        oks.append(ok)
    keep = torch.stack(keeps)
    anchor_ok = torch.stack(oks)
    fmask = keep.to(X.dtype)
    kept_ct = col.psum_model(torch.sum(keep, dim=1).to(torch.int32))
    resurrected = col.psum_model(
        torch.sum(keep & (fmask_prev < 0.5), dim=1).to(torch.int32))

    # -- one fetch: the kept counts pick the shared capacity, the smallest
    # of ``caps`` (ascending) that holds the live elements' largest count;
    # none does: m, mask mode
    kept_h = host_fetch(kept_ct, "step")
    k_max = max([k for k, a in zip(kept_h, act_h) if a], default=0)
    cap = next((int(c) for c in caps if k_max <= c), m)

    # -- solve and certify, one element after another (an element that is not
    # live, an empty server slot, keeps its carry and reports zeros)
    o = dict(max_iters=max_iters, tol=tol, dynamic=dynamic,
             screen_every=screen_every, tau=tau, exact_lipschitz=exact_lipschitz,
             col=col, cols=cols)
    outs, secs = [], []
    for e in range(B):
        if not act_h[e]:
            zero = torch.zeros((), dtype=X.dtype, device=X.device)
            outs.append((w[e], b[e], zero, zero.to(torch.int32), zero > 0, zero,
                         delta[e], theta[e], zero.to(torch.int32)))
            secs.append(0.0)
            continue
        Xe, ye, sme, _ = elem(e)
        t0 = time.perf_counter()
        w2, res = _solve_element(Xe, ye, sme, lam[e], inv_L[e], w[e], b[e],
                                 fmask[e], cap, kept_h[e], o)
        secs.append(time.perf_counter() - t0)
        theta2, delta2, gap = gap_theta_delta(Xe, ye, w2, res.b, lam[e], sme,
                                              n_feas_iters=n_feas_iters, u=res.u,
                                              col=col)
        outs.append((w2, res.b, res.obj, res.n_iters, res.converged, gap, delta2,
                     theta2, res.health))
    if telemetry is not None:
        telemetry.setdefault("solve_seconds", []).append(secs)
    w2, b2, obj, n_it, conv, gap, delta2, theta2, health = (
        torch.stack(list(v)) for v in zip(*outs))
    refused = torch.where(anchor_ok, 0, HEALTH_SCREEN_REFUSED).to(torch.int32)
    out = ScanPathOutputs(
        w=w2, b=b2, obj=obj, kept=kept_ct,
        active=col.psum_model(torch.sum(torch.abs(w2) > 1e-10, dim=1).to(torch.int32)),
        n_iters=n_it.to(torch.int32), converged=conv, gap=gap, delta=delta2,
        fmask=keep, cap=torch.full((B,), cap, dtype=torch.int32, device=X.device),
        resurrected=resurrected, health=health.to(torch.int32) | refused)
    new_carry = (w2, b2, theta2, delta2, lam, fmask)
    if hist:
        # two-anchor programs (dvi) carry the step-before-last anchor too
        new_carry = new_carry + (lam_prev, theta, delta)
    return new_carry, out


# -- whole paths -------------------------------------------------------------------


def _batched_path_scan_program(X, y, sm, lambdas, w0, b0, theta0, delta0, lam0,
                               L, tau, tol, *, max_iters: int, screening: bool,
                               dynamic: bool, screen_every: int,
                               exact_lipschitz: bool, reduce: str = "compact",
                               rules: tuple = ("feature_vi",),
                               shared_x: bool = False, n_feas_iters: int = 8,
                               telemetry: Optional[dict] = None,
                               col: Collectives = LOCAL,
                               cols: Optional[tuple] = None) -> ScanPathOutputs:
    """B whole paths, the grid walked step by step over the batch
    (:func:`_batched_path_step`); outputs lead with (B, T).

    ``shared_x``: one dataset and B grids (``X (m, n)``) or B problems
    (``X (B, m, n)``). ``lambdas`` (B, T) on X's device; the anchors
    ``(w0, b0, theta0, delta0, lam0)`` broadcast to B when given unbatched.
    ``L`` (None: estimated per dataset) is one value or (B,)."""
    m, n = X.shape[-2], X.shape[-1]
    dev, dt = X.device, X.dtype
    B, T = lambdas.shape
    caps = compact_caps(m) if reduce == "compact" else ()
    if L is None:
        L = (lipschitz_estimate(X, col=col, cols=cols) if shared_x
             else torch.stack([lipschitz_estimate(X[e]) for e in range(B)]))
    inv_L = torch.broadcast_to(_inv_L(torch.as_tensor(L, device=dev)), (B,))
    statics = _batched_statics(X, y, sm, shared_x)
    if col.psum_data is not _identity:
        statics = tuple(col.psum_data(torch.stack(statics)))
    act = [True] * B

    def bc(v, shape):
        return torch.broadcast_to(torch.as_tensor(v, dtype=dt, device=dev), shape).clone()

    carry = (bc(w0, (B, m)), bc(b0, (B,)), bc(theta0, (B, n)), bc(delta0, (B,)),
             bc(lam0, (B,)), torch.ones((B, m), dtype=dt, device=dev))
    if stack_needs_history(tuple(PROGRAMS[p] for p in rules) if screening else ()):
        # the old anchor starts as the initial one: step 1's two-anchor
        # bound is then the one-anchor bound, as the host DVIRule's
        carry = carry + (carry[4].clone(), carry[2].clone(), carry[3].clone())
    steps = []
    for k in range(T):
        carry, out = _batched_path_step(
            X, y, sm, statics, inv_L, tau, tol, carry, lambdas[:, k], act,
            caps=caps, shared_x=shared_x, max_iters=max_iters, screening=screening,
            dynamic=dynamic, screen_every=screen_every,
            exact_lipschitz=exact_lipschitz, rules=rules,
            n_feas_iters=n_feas_iters, telemetry=telemetry, col=col, cols=cols)
        steps.append(out)
    return ScanPathOutputs(*(torch.stack(list(v), dim=1) for v in zip(*steps)))


def _path_scan_program(X, y, lambdas, w0, b0, theta0, delta0, lam0, L, tau, tol,
                       *, max_iters: int, screening: bool, dynamic: bool,
                       screen_every: int, exact_lipschitz: bool,
                       reduce: str = "mask", rules: tuple = ("feature_vi",),
                       n_feas_iters: int = 8,
                       telemetry: Optional[dict] = None,
                       col: Collectives = LOCAL,
                       cols: Optional[tuple] = None) -> ScanPathOutputs:
    """The single-path program (the reference's): one element of
    :func:`_batched_path_scan_program`. ``lambdas`` (T,) on X's device;
    outputs lead with T. ``col``, ``cols``: a sharded seam (mask mode)."""
    outs = _batched_path_scan_program(
        X, y, None, lambdas[None, :], w0, b0, theta0, delta0, lam0, L, tau, tol,
        max_iters=max_iters, screening=screening, dynamic=dynamic,
        screen_every=screen_every, exact_lipschitz=exact_lipschitz, reduce=reduce,
        rules=rules, shared_x=True, n_feas_iters=n_feas_iters, telemetry=telemetry,
        col=col, cols=cols)
    return ScanPathOutputs(*(v[0] for v in outs))


def engine_cache_info() -> list[dict]:
    """The engines' warm cache: the captured FISTA chunk graphs
    (``solver.graph_cache_info``). A repeated same-shape path adds none."""
    return solver.graph_cache_info()


def _to_path_result(lambdas, outs, lam_max_val: float, wall_s: float,
                    static_kw: tuple, engine: str = "scan",
                    extras: Optional[dict] = None) -> PathResult:
    """A :class:`PathResult` from host copies of one element's outputs
    (numpy arrays, leading T), with its ``path_trace`` (the per-step solve
    seconds from ``extras["solve_seconds"]``); the run is folded into the
    ``path.*`` metrics."""
    T = len(lambdas)
    opts = dict(static_kw)
    extras = extras or {}
    per_step = np.full((T,), wall_s / max(T, 1), dtype=np.float64)
    kept, health = np.asarray(outs.kept, np.int64), np.asarray(outs.health, np.int64)
    path_trace = build_path_trace(
        engine, lambdas, kept, None, np.asarray(outs.active, np.int64),
        np.asarray(outs.n_iters, np.int64), per_step,
        gaps=np.asarray(outs.gap, np.float64), deltas=np.asarray(outs.delta, np.float64),
        health=health, solve_s=extras.get("solve_seconds"), total_s=float(wall_s),
        walls_observed=False, meta={"reduce": opts["reduce"], "lam_max": float(lam_max_val)})
    PathDriver._observe_run(engine, kept, health)
    return PathResult(
        lambdas=np.asarray(lambdas, np.float64),
        weights=np.asarray(outs.w, np.float64),
        biases=np.asarray(outs.b, np.float64),
        objectives=np.asarray(outs.obj, np.float64),
        kept=np.asarray(outs.kept, np.int64),
        active=np.asarray(outs.active, np.int64),
        solver_iters=np.asarray(outs.n_iters, np.int64),
        # the steps overlap on the device: report the uniform share of the
        # total (solve seconds per step are in extras)
        wall_times=per_step,
        screen_times=np.zeros((T,), np.float64),
        screened=bool(opts["screening"]),
        kept_samples=np.zeros((T,), np.int64),
        verify_rounds=np.zeros((T,), np.int64),
        rules=opts["rules"],
        extras={
            "engine": engine,
            "lam_max": float(lam_max_val),
            "total_seconds": float(wall_s),
            "gaps": np.asarray(outs.gap, np.float64),
            "deltas": np.asarray(outs.delta, np.float64),
            "converged": np.asarray(outs.converged, bool),
            "keep_masks": np.asarray(outs.fmask, bool),
            "caps": np.asarray(outs.cap, np.int64),
            "resurrected": np.asarray(outs.resurrected, np.int64),
            "health": np.asarray(outs.health, np.int64),
            "options": dict(static_kw),
            "path_trace": path_trace,
            **extras,
        },
    )


def _counters() -> tuple:
    return dict(solver.FETCHES), dict(solver.GRAPHS)


def _counters_since(before: tuple) -> dict:
    f, g = _counters()
    return {"host_fetches": {k: v - before[0][k] for k, v in f.items()},
            "graphs": {k: v - before[1][k] for k, v in g.items()}}


def _to_host(outs: ScanPathOutputs) -> ScanPathOutputs:
    """One read of every output (the path's last fetch)."""
    solver.FETCHES["result"] += 1
    return ScanPathOutputs(*(v.cpu().numpy() for v in outs))


def svm_path_scan(X, y, lambdas: Optional[Sequence[float]] = None,
                  n_lambdas: int = 10, lam_min_ratio: float = 0.1, *,
                  screening: bool = True, tau: float = SAFE_TAU,
                  tol: float = 1e-9, max_iters: int = 4000,
                  dynamic: bool = False, screen_every: int = 50,
                  exact_lipschitz: bool = False, reduce: str = "mask",
                  rules=None, L=None, device="cuda") -> PathResult:
    """The feature-screened path with every solver decision on the device.

    Semantics of the reference's ``svm_path_scan``: every step screens
    against the previous step's gap-certified anchor (step 0 from the
    closed form at ``lambda_max``), solves under the keep set to ``tol``
    and certifies its own anchor. ``rules`` is any stack of a-priori-safe
    feature rules with a program (``"feature_vi"``, ``"edpp"``, ``"dvi"``,
    ``"auto"``, a list: bounds min-composed); ``None`` is ``feature_vi``
    with ``screening=True``, ``"none"`` no screening; sample rules raise.
    ``reduce`` is ``"mask"`` or ``"compact"`` (see the module docstring);
    ``dynamic`` re-screens inside each solve every ``screen_every``
    iterations; ``exact_lipschitz`` re-estimates L on each step's reduced
    matrix. ``L`` (a number or 0-d tensor) skips the path's estimate. Runs
    on ``device``, by default the GPU."""
    static_kw = _static_opts(max_iters, screening, dynamic, screen_every,
                             exact_lipschitz, reduce, rules)
    opts = dict(static_kw)
    dev = resolve_device(device)
    X = torch.as_tensor(X).to(dev).contiguous()
    y = torch.as_tensor(y).to(device=dev, dtype=X.dtype)
    m = X.shape[0]
    before = _counters()
    t0 = time.perf_counter()
    lam_max_t = lambda_max(X, y)
    lam_max_val = float(host_fetch(lam_max_t, "setup"))
    if lambdas is None:
        lambdas = default_lambda_grid(lam_max_val, n_lambdas, lam_min_ratio)
    lambdas = _validate_grid(lambdas)
    lam0 = lam_max_t.to(X.dtype)
    tele: dict = {}
    outs = _path_scan_program(
        X, y, torch.as_tensor(lambdas, dtype=X.dtype).to(dev),
        torch.zeros((m,), dtype=X.dtype, device=dev), bias_at_lambda_max(y),
        theta_at_lambda_max(y, lam0), torch.zeros((), dtype=X.dtype, device=dev),
        lam0, L, float(tau), float(tol), max_iters=opts["max_iters"],
        screening=opts["screening"], dynamic=opts["dynamic"],
        screen_every=opts["screen_every"], exact_lipschitz=opts["exact_lipschitz"],
        reduce=opts["reduce"], rules=opts["rules"], telemetry=tele)
    outs = _to_host(outs)
    t1 = time.perf_counter()
    wall_s = t1 - t0
    obs_trace.complete("scan.dispatch", t0, t1, steps=len(lambdas), reduce=opts["reduce"])
    extras = {"solve_seconds": np.asarray([s[0] for s in tele["solve_seconds"]]),
              **_counters_since(before)}
    r = _to_path_result(lambdas, outs, lam_max_val, wall_s, static_kw, "scan", extras)
    r.extras["path_trace"].emit_to_tracer()
    return r


def svm_path_batched(X, y, lambdas: Optional[np.ndarray] = None,
                     n_lambdas: int = 10, lam_min_ratio: float = 0.1, *,
                     screening: bool = True, tau: float = SAFE_TAU,
                     tol: float = 1e-9, max_iters: int = 4000,
                     dynamic: bool = False, screen_every: int = 50,
                     exact_lipschitz: bool = False, reduce: str = "mask",
                     rules=None, L=None, device="cuda") -> list[PathResult]:
    """B paths at once (the reference's ``svm_path_batched``):

    * ``X (m, n)``, ``lambdas (B, T)``: one dataset, B grids;
    * ``X (B, m, n)``, ``y (B, n)``: B problems, on ``lambdas`` (one (T,)
      grid for all, or (B, T)) or each on its own geometric grid from its
      own ``lambda_max``.

    Every step screens all B elements, picks one shared compact capacity
    (``reduce="compact"``: the batch-max kept count; one overflowing
    element demotes the step to mask mode), and solves and certifies the
    elements one after another. Other options as :func:`svm_path_scan`.
    Returns one :class:`PathResult` per element (the shared wall in
    ``extras["total_seconds"]``, ``extras["batch"]``)."""
    static_kw = _static_opts(max_iters, screening, dynamic, screen_every,
                             exact_lipschitz, reduce, rules)
    opts = dict(static_kw)
    dev = resolve_device(device)
    X = torch.as_tensor(X)
    y = torch.as_tensor(y)
    if X.dim() == 2:
        if lambdas is None:
            raise ValueError("grid-batched mode (2-D X) needs an explicit (B, T) lambdas")
        grids = np.asarray(lambdas, np.float64)
        if grids.ndim != 2:
            raise ValueError(f"lambdas must be (B, T), got {grids.shape}")
        shared_x = True
    elif X.dim() == 3:
        if y.dim() != 2 or y.shape[0] != X.shape[0]:
            raise ValueError(f"y must be (B, n) for 3-D X, got {tuple(y.shape)}")
        shared_x = False
    else:
        raise ValueError(f"X must be (m, n) or (B, m, n), got {tuple(X.shape)}")
    X = X.to(dev).contiguous()
    y = y.to(device=dev, dtype=X.dtype)
    before = _counters()
    t0 = time.perf_counter()
    if shared_x:
        B, m = grids.shape[0], X.shape[0]
        lam_max_t = lambda_max(X, y)
        lam_maxs = np.full((B,), float(host_fetch(lam_max_t, "setup")))
        theta0 = theta_at_lambda_max(y, lam_max_t)
        b0 = bias_at_lambda_max(y)
    else:
        B, m = X.shape[0], X.shape[1]
        lam_max_t = torch.stack([lambda_max(X[e], y[e]) for e in range(B)])
        lam_maxs = np.asarray(host_fetch(lam_max_t, "setup"), np.float64)
        if lambdas is None:
            ratios = np.geomspace(1.0, lam_min_ratio, n_lambdas)
            grids = lam_maxs[:, None] * ratios[None, :]
        else:
            grids = np.asarray(lambdas, np.float64)
            if grids.ndim == 1:
                grids = np.broadcast_to(grids, (B, grids.shape[0])).copy()
        theta0 = torch.stack([theta_at_lambda_max(y[e], lam_max_t[e]) for e in range(B)])
        b0 = torch.mean(y, dim=1)
    for g in grids:
        _validate_grid(g)
    tele: dict = {}
    outs = _batched_path_scan_program(
        X, y, None, torch.as_tensor(grids, dtype=X.dtype).to(dev),
        torch.zeros((m,), dtype=X.dtype, device=dev), b0, theta0,
        torch.zeros((), dtype=X.dtype, device=dev), lam_max_t.to(X.dtype), L,
        float(tau), float(tol), max_iters=opts["max_iters"],
        screening=opts["screening"], dynamic=opts["dynamic"],
        screen_every=opts["screen_every"], exact_lipschitz=opts["exact_lipschitz"],
        reduce=opts["reduce"], rules=opts["rules"], shared_x=shared_x,
        telemetry=tele)
    outs = _to_host(outs)
    t1 = time.perf_counter()
    wall_s = t1 - t0
    obs_trace.complete("batched.dispatch", t0, t1, batch=B)
    counts = _counters_since(before)
    solve_s = np.asarray(tele["solve_seconds"])  # (T, B)
    results = []
    for i in range(B):
        sub = ScanPathOutputs(*(v[i] for v in outs))
        r = _to_path_result(grids[i], sub, float(lam_maxs[i]), wall_s / B, static_kw,
                            "batched", {"solve_seconds": solve_s[:, i], **counts})
        r.extras.update(total_seconds=float(wall_s), batch=B, batch_index=i)
        r.extras["path_trace"].meta["batch_index"] = i
        r.extras["path_trace"].emit_to_tracer()
        results.append(r)
    return results


def svm_path_scan_sharded(grid, X, y, lambdas: Optional[Sequence[float]] = None,
                          n_lambdas: int = 10, lam_min_ratio: float = 0.1, *,
                          screening: bool = True, tau: float = SAFE_TAU,
                          tol: float = 1e-9, max_iters: int = 4000,
                          dynamic: bool = False, exact_lipschitz: bool = False,
                          rules=None, L=None, device="cuda") -> PathResult:
    """The scan engine on a grid of ranks (reference
    ``svm_path_scan_sharded``): every rank of ``grid``
    (``distributed.svm_grid``) calls it with its block of X and its columns
    of y, and runs the steps of :func:`svm_path_scan` with the grid's seam.

    Per step: the screen from the carried anchor(s) (a grid with
    ``data == 1`` launches the feature screen on the rank's rows with global
    scalars; otherwise its partial mode, the all-reduce over samples and its
    finalize, for ``feature_vi``, ``edpp`` and ``dvi`` alike), the mask-mode
    solve (``solver.fista_run`` with the seam), the certificate
    (``gap_theta_delta`` with the seam); kept, active and resurrected counts
    are summed over features. ``lambda_max`` and the anchor at it come from
    all-reduced sums (``dual.lambda_max_sharded``); L from the sharded power
    iteration, which starts from the single-device start vector. On a ``1 x
    1`` grid every collective is the identity and the result is
    :func:`svm_path_scan`'s (``reduce="mask"``) bit for bit.

    Mask reduction only (compaction indexes global rows), no dynamic
    in-solver re-screen (the reference's ``ValueError``). Every rank returns
    the same :class:`PathResult`: weights and keep masks are gathered over
    the feature axis. ``extras`` add ``grid``, ``backend`` and
    ``allreduce`` (calls and bytes of this rank)."""
    from .distributed import ALLREDUCE, gather_rows  # lazy: distributed imports us

    if dynamic:
        raise ValueError(
            "dynamic in-solver screening is not supported on the sharded scan "
            "engine (nor on the reference's); use svm_path_scan(dynamic=True) on "
            "one device, or the host engine (svm_path(dynamic=True))")
    static_kw = _static_opts(max_iters, screening, False, 1, exact_lipschitz, "mask",
                             rules)
    opts = dict(static_kw)
    col = grid.col
    dev = resolve_device(device)
    X = torch.as_tensor(X).to(dev).contiguous()
    y = torch.as_tensor(y).to(device=dev, dtype=X.dtype)
    m_loc, n_loc = X.shape
    m, n = grid.shape(X)
    cols = (grid.j * n_loc, n)
    before = _counters()
    ar0 = dict(ALLREDUCE)
    t0 = time.perf_counter()
    lam_max_t = lambda_max_sharded(X, y, col, n)
    lam_max_val = float(host_fetch(lam_max_t, "setup"))
    if lambdas is None:
        lambdas = default_lambda_grid(lam_max_val, n_lambdas, lam_min_ratio)
    lambdas = _validate_grid(lambdas)
    lam0 = lam_max_t.to(X.dtype)
    if L is None:
        L = lipschitz_estimate(X, col=col, cols=cols)
    tele: dict = {}
    outs = _path_scan_program(
        X, y, torch.as_tensor(lambdas, dtype=X.dtype).to(dev),
        torch.zeros((m_loc,), dtype=X.dtype, device=dev),
        bias_at_lambda_max_sharded(y, col, n),
        theta_at_lambda_max_sharded(y, lam0, col, n),
        torch.zeros((), dtype=X.dtype, device=dev), lam0, L, float(tau), float(tol),
        max_iters=opts["max_iters"], screening=opts["screening"], dynamic=False,
        screen_every=opts["screen_every"], exact_lipschitz=opts["exact_lipschitz"],
        reduce="mask", rules=opts["rules"], telemetry=tele, col=col, cols=cols)
    outs = outs._replace(w=gather_rows(grid, outs.w),
                         fmask=gather_rows(grid, outs.fmask.to(torch.int32)) > 0,
                         cap=torch.full_like(outs.cap, m))
    outs = _to_host(outs)
    t1 = time.perf_counter()
    wall_s = t1 - t0
    obs_trace.complete("scan_sharded.dispatch", t0, t1, steps=len(lambdas))
    extras = {"solve_seconds": np.asarray([s[0] for s in tele["solve_seconds"]]),
              "grid": {"model": grid.model, "data": grid.data},
              "backend": grid.backend,
              "allreduce": {k: ALLREDUCE[k] - ar0[k] for k in ALLREDUCE},
              **_counters_since(before)}
    r = _to_path_result(lambdas, outs, lam_max_val, wall_s, static_kw, "scan_sharded",
                        extras)
    r.extras["path_trace"].emit_to_tracer()
    return r
