"""The safe-screening sweep over :class:`FeatureChunked`, chunk by chunk.

Port of the reference ``sparse/screen_stream.py``. The paper's screen
reduces each feature row on its own, so it streams: sweep one chunk at a
time and finalize each row with the region's shared scalars; the device
never holds more than the chunks in flight.

The pure-VI screen (:func:`screen_bounds_stream`, and the pure-VI step of
:func:`screen_step_stream`) launches the feature-screen kernel
(``kernels/screen.py`` ``screen_bounds_from_shared``) once per live chunk,
with the region's scalars packed once for all chunks: a dense chunk is
launched as it is, a CSR chunk on its rows written densely into the
container's reused ``(chunk_m, n)`` device buffer. The kernel sums each row with one warp in
an order that does not depend on how many rows it is given, so the
streamed bounds of a dense chunking equal the in-core launch's bit for bit.
One read of a chunk also gives the chunk's ``d_theta`` (the kernel's
optional output), the slice :class:`ChunkScreenCache` keeps. There is no
other route: on a CPU tensor the wrapper runs its plain version.

Theta-independent reductions (paper Sec. 6.4): ``d_one``, ``d_y`` and
``d_sq`` do not depend on the anchor, so :func:`fixed_reductions` streams
them once per container and ``y`` (T lambdas cost T + 1 streams, not 4T).

Chunk skipping: :class:`ChunkScreenCache` keeps, per chunk, the anchor of
the step that last streamed it (its scalars and that chunk's ``d_theta``).
A region built from a certified anchor at ``lam1`` is safe for every
target below ``lam1``, so the cached anchor's bounds at the current target
are valid bounds with no stream; a chunk whose largest such bound is below
tau is dead before its transfer. :func:`screen_step_stream` streams only
the live chunks and stamps the dead ones' features with their cached
bounds; its ``skip=False`` twin makes the same decisions and streams every
chunk, so the two give the same bits.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.rules.programs import PROGRAMS, stack_bounds
from ..core.screening import (
    SAFE_TAU,
    AnchorStats,
    FeatureReductions,
    FixedStats,
    anchor_stats,
    finalize_from_anchor,
    fixed_stats,
    shared_scalars,
)
from ..kernels.screen import pack_shared, screen_bounds_from_shared
from ..obs import trace as obs_trace
from .chunked import FeatureChunked, chunk_mv, dense_rows

__all__ = [
    "fixed_reductions",
    "stream_feature_reductions",
    "stream_anchor_stats",
    "stream_sample_stats",
    "screen_bounds_stream",
    "screen_stream",
    "screen_stack_stream",
    "screen_step_stream",
    "ChunkScreenCache",
    "lambda_max_stream",
]


def fixed_reductions(fc: FeatureChunked, y: torch.Tensor):
    """``(d_one, d_y, d_sq)`` for every feature, streamed once and memoized
    on the container, keyed on the identity of the caller's ``y`` (a
    different ``y`` object streams again)."""
    cached = getattr(fc, "_fixed_reductions", None)
    if cached is not None and cached[0] is y:
        return cached[1]
    m = fc.m
    out = tuple(torch.empty((m,), dtype=y.dtype, device=y.device)
                for _ in range(3))
    ones = torch.ones_like(y)
    for i, dev in fc.stream(y.device):
        s, e = fc.chunk_bounds(i)
        rows = dense_rows(dev)
        d = rows @ torch.stack([y, ones], dim=1)
        out[0][s:e], out[1][s:e] = d[:, 0], d[:, 1]
        out[2][s:e] = torch.sum(rows * rows, dim=1)
    fc._fixed_reductions = (y, out)
    return out


def _d_theta_stream(fc: FeatureChunked, yt: torch.Tensor, live_chunks=None,
                    fill=None) -> torch.Tensor:
    """``f_j . yt`` for every feature from one stream (``torch.mv`` a
    chunk); rows of dead chunks come from ``fill(i)``."""
    out = torch.empty((fc.m,), dtype=yt.dtype, device=yt.device)
    live = set(fc.live_order(live_chunks))
    for i, dev in fc.stream(yt.device, live_chunks):
        s, e = fc.chunk_bounds(i)
        out[s:e] = chunk_mv(dev, yt)
    for i in range(fc.n_chunks):
        if i not in live:
            s, e = fc.chunk_bounds(i)
            out[s:e] = fill(i)
    return out


def stream_feature_reductions(fc: FeatureChunked, y: torch.Tensor,
                              theta1: torch.Tensor) -> FeatureReductions:
    """The four screening reductions for every feature (one stream of X
    for ``d_theta``, the memoized :func:`fixed_reductions` for the rest)."""
    d_one, d_y, d_sq = fixed_reductions(fc, y)
    return FeatureReductions(d_theta=_d_theta_stream(fc, y * theta1),
                             d_one=d_one, d_y=d_y, d_sq=d_sq)


class _KernelScreen:
    """Launches the feature-screen kernel on device chunks with one region,
    its scalars packed once; a CSR chunk is launched on its dense rows."""

    def __init__(self, y, theta1, sh):
        self.y, self.theta1, self.sh = y, theta1, sh
        self.packed = (pack_shared(sh).to(y.device) if y.device.type == "cuda"
                       else None)

    def __call__(self, dev):
        """``(bounds, d_theta)`` of one device chunk."""
        return screen_bounds_from_shared(dense_rows(dev), self.y, self.theta1,
                                         self.sh, want_d_theta=True,
                                         scalars=self.packed)


def screen_bounds_stream(fc: FeatureChunked, y: torch.Tensor, lam1, lam2,
                         theta1: torch.Tensor, delta=0.0) -> torch.Tensor:
    """Upper bounds on ``|fhat_j^T theta*(lam2)|``, one kernel launch per
    chunk (see the module docstring)."""
    launch = _KernelScreen(y, theta1, shared_scalars(y, lam1, lam2, theta1, delta=delta))
    out = torch.empty((fc.m,), dtype=torch.float32, device=y.device)
    for i, dev in fc.stream(y.device):
        s, e = fc.chunk_bounds(i)
        out[s:e] = launch(dev)[0]
    return out


def screen_stream(fc: FeatureChunked, y, lam1, lam2, theta1,
                  tau: float = SAFE_TAU, delta=0.0):
    """Safe screening over chunked storage: ``(keep_mask, bounds)``; a
    non-finite bound keeps its feature."""
    bounds = screen_bounds_stream(fc, y, lam1, lam2, theta1, delta=delta)
    return ~(bounds < tau), bounds


def stream_anchor_stats(fc: FeatureChunked, y, lam1, theta1, delta=0.0,
                        live_chunks=None,
                        cache: Optional["ChunkScreenCache"] = None) -> AnchorStats:
    """:class:`~repro_torch.core.screening.AnchorStats` from one stream of
    X (its ``d_theta``). ``live_chunks`` restricts the stream; dead chunks'
    ``d_theta`` slices come from ``cache`` (stale, valid only through the
    cache's own bounds), and the live chunks' cache entries are refreshed."""
    if live_chunks is None:
        anchor = anchor_stats(y, lam1, theta1, delta,
                              _d_theta_stream(fc, y * theta1))
        if cache is not None:
            cache.refresh(anchor, live=None)
        return anchor
    if cache is None:
        raise ValueError("live_chunks needs a ChunkScreenCache for the "
                         "dead chunks' d_theta slices")
    anchor = anchor_stats(y, lam1, theta1, delta,
                          _d_theta_stream(fc, y * theta1, live_chunks,
                                          cache.d_theta_slice))
    cache.refresh(anchor, live=set(fc.live_order(live_chunks)))
    return anchor


def stream_sample_stats(fc: FeatureChunked, y, w1, b1):
    """The sample-axis sweep: ``(u1 = X^T w1 + b1, ||x_i||^2)``, one stream
    for ``u1`` and the memoized :meth:`FeatureChunked.col_sq`: every input
    of ``rules/sample_vi.margin_surplus_core``."""
    u1 = fc.rmatvec(w1) + torch.as_tensor(b1, dtype=y.dtype, device=y.device)
    return u1, fc.col_sq(y.device)


class ChunkScreenCache:
    """Per-chunk stale-anchor state for chunk-level safe screening.

    Each chunk keeps the :class:`AnchorStats` scalars of the step that last
    streamed it and its own ``d_theta`` slice from that stream.
    :meth:`live_mask` evaluates each chunk's cached region at the current
    target and declares the chunk dead when all of its bounds are below
    tau; live chunks are refreshed after each stream."""

    def __init__(self, fc: FeatureChunked):
        self.fc = fc
        self._scalars: list = [None] * fc.n_chunks  # (lam, delta, tdo, tdy, tsq)
        self._d_theta: list = [None] * fc.n_chunks
        self._lam_host: list = [None] * fc.n_chunks

    def d_theta_slice(self, i: int) -> torch.Tensor:
        part = self._d_theta[i]
        if part is None:
            raise ValueError(f"chunk {i} marked dead but never streamed")
        return part

    def refresh(self, anchor: AnchorStats, live=None) -> None:
        """Record ``anchor`` (full-``m`` ``d_theta``) as the cached region
        of the streamed chunks (``live=None``: all). A poisoned anchor (a
        non-finite scalar or ``d_theta`` entry) invalidates those entries
        instead, so they count as never streamed (always live)."""
        vals = torch.stack([anchor.lam, anchor.delta, anchor.theta_dot_one,
                            anchor.theta_dot_y, anchor.theta_sq]).double()
        flags = torch.cat([vals, torch.isfinite(anchor.d_theta).all()
                           .double().reshape(1)]).tolist()  # one host fetch
        lam_host = flags[0]
        bad = not (all(np.isfinite(flags[:5])) and flags[5] > 0.5)
        scalars = (anchor.lam, anchor.delta, anchor.theta_dot_one,
                   anchor.theta_dot_y, anchor.theta_sq)
        for i in range(self.fc.n_chunks):
            if live is not None and i not in live:
                continue
            if bad:
                self._scalars[i] = self._d_theta[i] = self._lam_host[i] = None
                continue
            s, e = self.fc.chunk_bounds(i)
            self._scalars[i] = scalars
            self._d_theta[i] = anchor.d_theta[s:e]
            self._lam_host[i] = lam_host

    def chunk_anchor(self, i: int) -> Optional[AnchorStats]:
        if self._scalars[i] is None:
            return None
        lam, delta, tdo, tdy, tsq = self._scalars[i]
        return AnchorStats(lam=lam, delta=delta, theta_dot_one=tdo,
                           theta_dot_y=tdy, theta_sq=tsq,
                           d_theta=self._d_theta[i])

    def live_mask(self, lam2, fixed: FixedStats, tau: float = SAFE_TAU):
        """``(live, stale_bounds)`` for the target ``lam2``.

        ``live[i]`` is True when chunk ``i`` must be streamed: no cached
        region, a region that does not certify ``lam2`` (only strictly
        smaller targets), or a cached bound that is not below tau (a NaN
        bound keeps its chunk live). ``stale_bounds`` (m,) holds the cached
        regions' bounds (+inf where there is none): every finite entry is a
        valid bound, and a dead chunk's entries are all below tau.

        The chunks that share a cached anchor (at most one group per path
        step) are evaluated together, one ``finalize_from_anchor`` over the
        group's rows; each chunk's "some bound not below tau" is counted on
        the device, and the counts come to the host in one fetch. Row by
        row the arithmetic is the per-chunk evaluation's, so the decisions
        are the same."""
        fc = self.fc
        lam2_host = float(lam2)
        groups: dict = {}
        for i in range(fc.n_chunks):
            if self._scalars[i] is not None and lam2_host < self._lam_host[i]:
                groups.setdefault(id(self._scalars[i]), []).append(i)
        ref = fixed.d_one
        stale = torch.full((fc.m,), float("inf"), dtype=ref.dtype,
                           device=ref.device)
        live = np.ones((fc.n_chunks,), dtype=bool)
        if not groups:
            return live, stale
        sizes = np.diff(fc.offsets)
        counts, order = [], []
        for chunks in groups.values():
            rows = np.concatenate([np.arange(*fc.chunk_bounds(i)) for i in chunks])
            idx = torch.from_numpy(rows).to(ref.device)
            a = self.chunk_anchor(chunks[0])._replace(
                d_theta=torch.cat([self._d_theta[i] for i in chunks]))
            fx = fixed._replace(d_one=fixed.d_one[idx], d_y=fixed.d_y[idx],
                                d_sq=fixed.d_sq[idx])
            b = finalize_from_anchor(a, lam2, fx)
            stale[idx] = b
            owner = torch.repeat_interleave(
                torch.arange(len(chunks), device=ref.device),
                torch.from_numpy(sizes[chunks]).to(ref.device),
                output_size=len(rows))
            above = torch.zeros((len(chunks),), dtype=torch.int64, device=ref.device)
            above.index_add_(0, owner, (~(b < tau)).long())
            counts.append(above)
            order.extend(chunks)
        live[order] = torch.cat(counts).cpu().numpy() > 0
        return live, stale


def screen_step_stream(
    fc: FeatureChunked,
    y: torch.Tensor,
    lam1,
    lam2,
    theta1: torch.Tensor,
    delta=0.0,
    rules: tuple = ("feature_vi",),
    tau: float = SAFE_TAU,
    cache: Optional[ChunkScreenCache] = None,
    anchor_old: Optional[AnchorStats] = None,
    skip: bool = True,
):
    """One path step's screen with chunk skipping.

    Returns ``(keep, bounds, anchor, live)``: the per-feature keep mask and
    bounds, the fresh :class:`AnchorStats` and the chunk live mask used.
    Dead chunks, certified by their cached regions, are not transferred
    when ``skip``; with ``skip=False`` every chunk is streamed and the
    decisions, the cache and the results are the same. Dead chunks'
    features carry their cached bounds (all below tau).

    ``rules == ("feature_vi",)`` with no ``anchor_old`` launches the
    feature-screen kernel per live chunk (bounds and ``d_theta`` from one
    read). Other stacks (``edpp``, ``dvi``) are evaluated by
    ``stack_bounds`` from the streamed anchors; a stack that carries
    history (``dvi``) streams every chunk every step, since an anchor whose
    dead-chunk entries are stale would be invalid as the next step's old
    anchor. With tracing on, the call is a ``stream.screen`` span."""
    t_start = time.perf_counter()
    d_one, d_y, d_sq = fixed_reductions(fc, y)
    fixed = fixed_stats(y, d_one, d_y, d_sq)
    if cache is None:
        cache = ChunkScreenCache(fc)
    needs_hist = (anchor_old is not None
                  or any(PROGRAMS[nm].n_anchors > 1 for nm in rules))
    if needs_hist:
        live = np.ones((fc.n_chunks,), dtype=bool)
        stale = None
    else:
        live, stale = cache.live_mask(lam2, fixed, tau)
    live_arg = None if bool(live.all()) else live
    live_set = set(int(i) for i in np.nonzero(live)[0])

    if tuple(rules) == ("feature_vi",) and anchor_old is None:
        launch = _KernelScreen(y, theta1,
                               shared_scalars(y, lam1, lam2, theta1, delta=delta))
        bounds = torch.zeros((fc.m,), dtype=torch.float32, device=y.device)
        d_theta = torch.empty((fc.m,), dtype=y.dtype, device=y.device)
        for i, dev in fc.stream(y.device, live_arg if skip else None):
            s, e = fc.chunk_bounds(i)
            b_i, d_i = launch(dev)
            bounds[s:e] = b_i  # a dead chunk's rows are stamped below
            if i in live_set:
                d_theta[s:e] = d_i
        for i in range(fc.n_chunks):
            if i not in live_set:
                s, e = fc.chunk_bounds(i)
                d_theta[s:e] = cache.d_theta_slice(i)
        anchor = anchor_stats(y, lam1, theta1, delta, d_theta)
        cache.refresh(anchor, live=live_set)
    else:
        anchor = stream_anchor_stats(
            fc, y, lam1, theta1, delta=delta,
            live_chunks=live_arg if skip else None,
            cache=cache if skip else None)
        if not skip:
            # the full-stream twin: dead chunks' entries must not advance,
            # so the cache evolves as in the skipping run
            cache.refresh(anchor, live=live_set)
        anchors = (anchor,) if anchor_old is None else (anchor_old, anchor)
        bounds = stack_bounds(tuple(PROGRAMS[nm] for nm in rules), lam2,
                              anchors, fixed)

    if live_arg is not None:
        dead = torch.from_numpy(np.repeat(~live, np.diff(fc.offsets))).to(y.device)
        bounds = torch.where(dead, stale.to(bounds.dtype), bounds)
    if obs_trace.enabled():
        obs_trace.complete("stream.screen", t_start, time.perf_counter(),
                           live=int(np.count_nonzero(live)),
                           chunks=int(fc.n_chunks), skip=bool(skip))
    return ~(bounds < tau), bounds, anchor, live


def screen_stack_stream(fc: FeatureChunked, y, lam2, anchors, rules,
                        tau: float = SAFE_TAU):
    """A stack of rule programs (names in ``PROGRAMS``) over chunked
    storage, from streamed anchors (oldest first) and the memoized fixed
    reductions; nothing here streams X again. ``(keep, bounds)``."""
    fixed = fixed_stats(y, *fixed_reductions(fc, y))
    bounds = stack_bounds(tuple(PROGRAMS[nm] for nm in rules), lam2, anchors,
                          fixed)
    return ~(bounds < tau), bounds


def lambda_max_stream(fc: FeatureChunked, y: torch.Tensor) -> torch.Tensor:
    """``|| X (y - mean y) ||_inf`` over the chunks (``core/dual.lambda_max``
    without an in-core X); a max of chunk maxima is exact. The per-chunk
    ``torch.mv`` may sum a row in another order than one over all of X, so
    the value can differ from the in-core one in its last bits."""
    v = y - torch.mean(y)
    best = torch.zeros((), dtype=y.dtype, device=y.device)
    for _, dev in fc.stream(y.device):
        best = torch.maximum(best, torch.max(torch.abs(chunk_mv(dev, v))))
    return best
