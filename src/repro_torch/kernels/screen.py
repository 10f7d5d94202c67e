"""The two screening sweeps, one per axis: CUDA kernels and plain versions.

*Feature axis* (:func:`screen_bounds_from_shared`). One read of X gives
every feature row's four reductions ``[f.(y theta1), f.y, f.1, ||f||^2]``;
the closed-form bound of ``core/screening.py``
(:func:`~repro_torch.core.screening._t_max`) is then applied in registers
and only the ``(m,)`` bounds are written. The feature-independent scalars
travel as one packed fp32 vector (:func:`pack_shared`), in the reference's
``pack_shared`` order, and stay on the device. Kernel: ``csrc/screen.cu``,
replacing the reference's Pallas ``_feature_kernel``: a sweep of rows cut
into column segments (:func:`screen_plan`, whose split depends on n and the
item size alone) and a finalize that adds a row's segments in order. It has
a bulk variant (16-byte loads, rows 16-byte aligned) and a scalar one,
which sum in the same order; :data:`VARIANTS` counts which ran.

*Sample axis* (:func:`sample_surplus_op`). One transposed read of X gives
every sample column's ``u_i = x_i.w1 + b1`` and ``||x_i||^2``; the margin
surplus ``y_i u_i - 1 - slack_i`` of ``core/rules/sample_vi.py`` is then
applied per column. The slack scalars are packed by
:func:`pack_sample_scalars`, in the reference's order and clamps. Kernel:
``csrc/sample.cu``, replacing the reference's Pallas ``_sample_kernel``.

The feature screen has a dynamic variant for the in-solver refresh
(``core/solver.py`` ``refresh_bounds``): sample weights restrict the three
theta-independent reductions to the live samples, and a flag in the packed
scalars caps the bound at the gap sphere's ``|d_theta| + ||f|| delta``. It
is the same kernel and the same read of X, counted apart as
``screen_bounds_dynamic``.

The feature screen's EDPP mode (:func:`screen_bounds_edpp`) is a third
mode of the same kernel, chosen by a launch argument: the same four
reductions and VI bound, then the EDPP projection ball from three more
packed scalars (:class:`~repro_torch.core.screening.EDPPShared`) and the
min of the two, in the same read of X. Its plain version is the ``edpp``
rule program over the four reductions (``core/rules/programs.py``).
Counted apart as ``screen_bounds_edpp``. With sample weights (the path
server's 0/1 mask of a padded slot's live columns) it is the weighted
instantiation's EDPP mode, over the weighted reductions, counted as
``screen_bounds_edpp_weighted``.

Partial modes (a sharded run, ``core/distributed.py``): the feature
screen's (:func:`screen_partial_op`, its four sums in either instantiation)
and the sample sweep's (:func:`sample_partial_op`, its two column sums)
stop before their finalizers; the caller all-reduces the sums and
:func:`screen_finalize_op` / :func:`sample_finalize_op` apply the kernels'
own finalizers to them. On an unsplit X each pair gives its full launch's
bits.

For a CUDA ``X`` each entry point launches its kernel and counts the launch
in :data:`LAUNCHES`; for a CPU ``X`` it runs the plain version beside it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core.screening import (
    EDPPShared,
    FeatureReductions,
    ScreenShared,
    edpp_bounds_from_reductions,
    feature_reductions,
    screen_bounds_from_reductions,
    shared_scalars,
)
from . import build
from .hinge import (
    _cdiv,
    _round_up,
    bulk_aligned,
    column_sweep_plan,
    sm_count,
    split_start,
)

#: launches of the kernel in this process (reset by ``ops.reset_launch_counts``);
#: ``*_partial`` and ``*_finalize`` are the partial modes (a sharded run)
LAUNCHES = {"screen_bounds": 0, "screen_bounds_dynamic": 0,
            "screen_bounds_edpp": 0, "screen_bounds_edpp_weighted": 0,
            "sample_surplus": 0, "screen_partial": 0, "screen_finalize": 0,
            "sample_partial": 0, "sample_finalize": 0}
#: launches of each variant of the sample-surplus and feature-screen sweeps
VARIANTS = {name: {"bulk": 0, "scalar": 0} for name in (
    "sample_surplus", "sample_partial", "screen_bounds", "screen_bounds_dynamic",
    "screen_bounds_edpp", "screen_bounds_edpp_weighted", "screen_partial")}

NUM_SCALARS = 12  # packed scalars, padded as in the reference
NUM_SCALARS_EDPP = 16  # the feature screen's EDPP mode: 12, then 3, padded
_BIG = 1e30  # stands in for inf in the sample finalizer (no 0 * inf = NaN)

# -- the feature screen's launch plan (csrc/screen.cu) ------------------------
# The sweep cuts every feature row longer than SCREEN_ROW_COLS columns into
# column segments of at most SCREEN_SEG_BYTES (a shorter row is one segment,
# and its warp finalizes it: no scratch, no second kernel); a tile is one
# row's segment, summed by one warp into the (segs * 4, m) scratch; the
# finalize adds a row's segments in order. The split depends on n and the
# item size alone, never on m or the alignment, so a row's bits do not
# depend on how many rows a launch holds or on its variant. The grid is
# SCREEN_BLOCKS_PER_SM whole waves of the card's SMs; a block takes a run of
# consecutive tiles in segment-major order.
SCREEN_BLOCKS_PER_SM = 2   # csrc/screen.cu kBlocksPerSM (blocks of 8 warps)
SCREEN_SEG_BYTES = 8 * 1024
SCREEN_ROW_COLS = 4096     # a row of at most this many columns is one segment
SCREEN_VECTORS = 3         # staged fp32 columns: y theta1, y w, w


class ScreenPlan(NamedTuple):
    """How the feature screen cuts X (m, n): ``segs`` column segments of
    ``seg_cols`` columns (the last one shorter); tile ``t`` is segment
    ``t // m``, row ``t % m`` (segment-major), and block ``b`` takes the
    consecutive tiles :meth:`tiles_of`. ``bulk``: 16-byte vector loads
    (rows 16-byte aligned); otherwise the scalar variant, same walk and
    order."""

    bulk: bool
    grid: int
    m: int
    n: int
    itemsize: int
    seg_cols: int

    @property
    def segs(self) -> int:
        return _cdiv(self.n, self.seg_cols)

    @property
    def tiles(self) -> int:
        return self.segs * self.m

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a block takes: the segment's staged columns
        (csrc/screen.cu launch_sweep)."""
        return SCREEN_VECTORS * _round_up(self.seg_cols, 16 // self.itemsize) * 4

    def tiles_of(self, b: int) -> range:
        return range(split_start(b, self.tiles, self.grid),
                     split_start(b + 1, self.tiles, self.grid))

    def tile(self, t: int) -> tuple[int, range]:
        """(row, columns) of tile ``t``."""
        seg, row = divmod(t, self.m)
        c0 = seg * self.seg_cols
        return row, range(c0, min(c0 + self.seg_cols, self.n))

    def scratch_shape(self) -> tuple[int, int]:
        """The fp32 partial sums: four rows a segment."""
        return (4 * self.segs, self.m)


@functools.lru_cache(maxsize=256)
def screen_plan(m: int, n: int, itemsize: int, aligned: bool, sms: int) -> ScreenPlan:
    """The feature screen's plan (see :class:`ScreenPlan`), its column split
    from n and the item size alone: one segment for a row of at most
    SCREEN_ROW_COLS columns, else segments of at most SCREEN_SEG_BYTES, their
    width a whole number of 16-byte units. On an H100
    (``scripts/torch_screen_tune.py``) 8 KB segments fill the card at a
    2,048-row chunk of 10,000 columns, and a 4,096-column row ran faster
    whole than in two segments."""
    segs = 1 if n <= SCREEN_ROW_COLS else _cdiv(n * itemsize, SCREEN_SEG_BYTES)
    seg = _round_up(_cdiv(n, segs), 16 // itemsize)
    plan = ScreenPlan(aligned, sms * SCREEN_BLOCKS_PER_SM, m, n, itemsize, seg)
    if plan.tiles >= 2 ** 31:
        raise ValueError(f"X of shape ({m}, {n}) has {plan.tiles} screen tiles, "
                         "past the kernel's 32-bit tile index")
    return plan


def _plan_of(X) -> ScreenPlan:
    m, n = X.shape
    return screen_plan(m, n, X.element_size(), bulk_aligned(X), sm_count(X.device))


def pack_shared(sh: ScreenShared, cap_delta=None,
                edpp: EDPPShared = None) -> torch.Tensor:
    """Pack the scalars the finalizer reads into a flat (12,) fp32 vector:
    ``inv_lam1, inv_lam2, yc, ysq, r_h_sq, g0, qa_sq, a_norm, a_dot_y,
    halfspace_valid``, then the gap-sphere cap ``(1, delta)`` when
    ``cap_delta`` (a 0-d tensor on the scalars' device) is given, else
    ``(0, 0)``. With ``edpp``, the EDPP mode's ``mu, yc, r_h_sq`` follow in
    slots 12-14 of a (16,) vector. Stays on the scalars' device."""
    vals = [sh.inv_lam1, sh.inv_lam2, sh.yc, sh.ysq, sh.r_h_sq, sh.g0,
            sh.qa_sq, sh.a_norm, sh.a_dot_y, sh.halfspace_valid]
    if cap_delta is not None:
        vals += [torch.ones_like(sh.a_norm), cap_delta]
    v = torch.stack([torch.as_tensor(x).to(torch.float32) for x in vals])
    v = torch.nn.functional.pad(v, (0, NUM_SCALARS - v.shape[0]))
    if edpp is None:
        return v
    e = torch.stack([x.to(torch.float32) for x in (edpp.mu, edpp.yc, edpp.r_h_sq)])
    return torch.nn.functional.pad(torch.cat([v, e.to(v.device)]),
                                   (0, NUM_SCALARS_EDPP - NUM_SCALARS - 3))


def screen_partial_plain(X, y, theta1, weights=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`screen_partial_op`: the four
    reductions of ``feature_reductions`` as a (4, m) fp32 stack."""
    red = feature_reductions(X.float(), y.float(), theta1.float(),
                             None if weights is None else weights.float())
    return torch.stack(list(red))


def screen_finalize_plain(sums, sh: ScreenShared, cap_delta=None,
                          edpp: EDPPShared = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`screen_finalize_op`."""
    red = FeatureReductions(*sums)
    if edpp is not None:
        return edpp_bounds_from_reductions(red, sh, edpp)
    bounds = screen_bounds_from_reductions(red, sh)
    if cap_delta is not None:
        delta = pack_shared(sh, cap_delta)[11]  # the fp32 value the kernel reads
        sphere = (torch.abs(red.d_theta)
                  + torch.sqrt(torch.clamp_min(red.d_sq, 0.0)) * delta)
        bounds = torch.minimum(bounds, sphere)  # NaN-propagating, as jnp.minimum
    return bounds


def screen_bounds_plain(X, y, theta1, sh: ScreenShared, weights=None,
                        cap_delta=None, want_d_theta: bool = False):
    """Plain PyTorch version of :func:`screen_bounds_from_shared`."""
    sums = screen_partial_plain(X, y, theta1, weights)
    bounds = screen_finalize_plain(sums, sh, cap_delta)
    return (bounds, sums[0]) if want_d_theta else bounds


def _launch_features(X, y, theta1, scalars, weights, edpp, name,
                     want_d_theta=False):
    """One launch of the feature screen (sweep and finalize); ``(m,)`` fp32
    bounds, and with ``want_d_theta`` the ``(m,)`` fp32 ``d_theta`` the
    kernel summed."""
    build.check_matrix(X)
    m, n = X.shape
    build.check_vector(y, n, X, "y")
    build.check_vector(theta1, n, X, "theta1")
    if weights is not None:
        build.check_vector(weights, n, X, "weights")
    plan = _plan_of(X)
    f32 = dict(dtype=torch.float32, device=X.device)
    part = torch.empty(plan.scratch_shape(), **f32) if plan.segs > 1 else None
    bounds = torch.empty((m,), **f32)
    d_theta = torch.empty((m,), **f32) if want_d_theta else None
    dev, stream = build.stream_and_device(X)
    err = build.library().screen_bounds_features(
        X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(),
        theta1.data_ptr(), None if weights is None else weights.data_ptr(),
        scalars.data_ptr(), m, n, int(plan.bulk), plan.grid, plan.seg_cols,
        None if part is None else part.data_ptr(), bounds.data_ptr(),
        None if d_theta is None else d_theta.data_ptr(), int(edpp), dev, stream)
    build.check(err, name)
    LAUNCHES[name] += 1
    VARIANTS[name]["bulk" if plan.bulk else "scalar"] += 1
    return (bounds, d_theta) if want_d_theta else bounds


def screen_bounds_from_shared(X, y, theta1, sh: ScreenShared, weights=None,
                              cap_delta=None, want_d_theta: bool = False,
                              scalars=None):
    """Per-feature VI bounds ``(m,)`` fp32 from one sweep of X, given the
    region's shared scalars ``sh`` (``core/screening.shared_scalars``).

    The dynamic variant: ``weights`` (n,) fp32 weights the theta-independent
    reductions (``sh`` must come from the same weighted statistics), and
    ``cap_delta`` (a 0-d tensor) takes the elementwise min with
    ``|d_theta| + ||f|| * cap_delta``.

    ``want_d_theta`` returns ``(bounds, d_theta)``: the kernel also writes
    each row's ``f_j . (y theta1)`` from the same read of X (the plain
    version returns ``feature_reductions(...).d_theta``). ``scalars``: the
    packed form of ``sh`` (:func:`pack_shared`) on X's device, for a caller
    that launches the kernel on many chunks of X with one region (packing
    costs a few small kernels a call)."""
    if not build.on_card(X):
        return screen_bounds_plain(X, y, theta1, sh, weights, cap_delta,
                                   want_d_theta)
    name = ("screen_bounds" if weights is None and cap_delta is None
            else "screen_bounds_dynamic")
    if scalars is None:
        scalars = pack_shared(sh, cap_delta).to(X.device)
    return _launch_features(X, y, theta1, scalars, weights, False, name,
                            want_d_theta)


def screen_bounds_edpp_plain(X, y, theta1, sh: ScreenShared, edpp: EDPPShared,
                             weights=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`screen_bounds_edpp`: the ``edpp``
    rule program (``stack_bounds(("edpp",), ...)``) over the four
    reductions (weighted by ``weights``), fp32."""
    return screen_finalize_plain(screen_partial_plain(X, y, theta1, weights), sh,
                                 edpp=edpp)


def screen_bounds_edpp(X, y, theta1, sh: ScreenShared, edpp: EDPPShared,
                       weights=None) -> torch.Tensor:
    """Per-feature EDPP bounds ``(m,)`` fp32 from one sweep of X: the EDPP
    projection ball on the hyperplane, min-composed with the VI bound of
    the same anchor. ``sh`` are the anchor's VI scalars
    (``core/screening.shared_scalars``) and ``edpp`` its EDPP scalars
    (``core/screening.edpp_scalars``), both from the same anchor, in its
    dtype and on its device. ``weights`` (n,): the 0/1 live samples of a
    sample-masked problem; the reductions are then weighted as the dynamic
    variant weights them, and ``sh`` and ``edpp`` must come from the same
    weighted statistics (``one_y = y.s``, ``n_tot = sum(s)``)."""
    if not build.on_card(X):
        return screen_bounds_edpp_plain(X, y, theta1, sh, edpp, weights)
    name = "screen_bounds_edpp" if weights is None else "screen_bounds_edpp_weighted"
    return _launch_features(X, y, theta1, pack_shared(sh, edpp=edpp).to(X.device),
                            weights, True, name)


def screen_bounds_op(X, y, lam1, lam2, theta1, delta=0.0) -> torch.Tensor:
    """Fused screening bounds for all m features, targeting ``lam2`` from the
    anchor ``theta1`` at ``lam1`` with inexactness radius ``delta`` (which
    enters only through the shared scalars)."""
    sh = shared_scalars(y.float(), lam1, lam2, theta1.float(), delta=delta)
    return screen_bounds_from_shared(X, y, theta1, sh)


def pack_sample_scalars(b1, dw, db, shrink_factor, margin_floor,
                        has_history, device="cpu") -> torch.Tensor:
    """Pack the sample finalizer's scalars into a flat (12,) fp32 vector on
    ``device``: ``b1, min(dw, 1e30), min(db, 1e30), shrink_factor,
    margin_floor, has_history``, zero-padded (the reference's
    ``pack_sample_scalars``).

    The values are numbers (a 0-d tensor is read to the host). The vector is
    packed on the host and reaches the card in one non-blocking copy: a
    blocking copy per value would synchronise the stream each time, and the
    card would idle while the wrapper's Python runs (on an H100, 1.10 ms a
    call against 0.82 ms at 50,000 x 10,000 fp32;
    ``scripts/torch_sample_pack_ab.py``)."""
    vals = [b1, dw, db, shrink_factor, margin_floor, 1.0 if has_history else 0.0]
    v = torch.zeros((NUM_SCALARS,), dtype=torch.float32)
    v[:len(vals)] = torch.tensor([float(x) for x in vals], dtype=torch.float32)
    v[1:3] = torch.clamp_max(v[1:3], _BIG)
    return v.to(device, non_blocking=True)


def sample_partial_plain(X, w1) -> torch.Tensor:
    """Plain PyTorch version of :func:`sample_partial_op`."""
    Xf = X.float()
    return torch.stack([torch.mv(Xf.t(), w1.float()), torch.sum(Xf * Xf, dim=0)])


def sample_finalize_plain(sums, y, b1, dw=float("inf"), db=float("inf"),
                          u_prev=None, shrink_factor=2.0, margin_floor=1e-3):
    """Plain PyTorch version of :func:`sample_finalize_op`."""
    sc = pack_sample_scalars(b1, dw, db, shrink_factor, margin_floor,
                             u_prev is not None, device=sums.device)
    u = sums[0] + sc[0]
    slack = torch.sqrt(torch.clamp_min(sums[1], 0.0)) * sc[1] + sc[2]
    if u_prev is not None:
        slack = torch.minimum(slack, sc[3] * torch.abs(u - u_prev) + sc[4])
    slack = torch.clamp_max(slack, _BIG)
    return y * u - 1.0 - slack, u


def sample_surplus_plain(X, w1, y, b1, dw=float("inf"), db=float("inf"),
                         u_prev=None, shrink_factor=2.0, margin_floor=1e-3):
    """Plain PyTorch version of :func:`sample_surplus_op` (fp32 sums).

    The finalizer is the reference kernel's (``_sample_surplus_from_acc``):
    ``dw`` and ``db`` clamp at 1e30, the secant applies only with
    ``u_prev``, and the total slack clamps at 1e30. Returns ``(surplus,
    u)``, both (n,) fp32, with ``u = X^T w1 + b1``.
    """
    return sample_finalize_plain(sample_partial_plain(X, w1), y, b1, dw, db,
                                 u_prev, shrink_factor, margin_floor)


def sample_surplus_op(X, w1, y, b1, dw=float("inf"), db=float("inf"),
                      u_prev=None, shrink_factor=2.0, margin_floor=1e-3):
    """Per-sample margin surplus ``y_i u_i - 1 - slack_i`` from one
    transposed sweep of X, and the margins ``u = X^T w1 + b1`` it used.

    ``X`` (m, n) fp32/bf16; ``w1`` (m,), ``y`` (n,) and ``u_prev`` (n,) or
    ``None`` fp32 on X's device; ``b1``, ``dw``, ``db`` numbers or 0-d
    tensors. Returns ``(surplus, u)``, both (n,) fp32 on X's device.
    """
    if not build.on_card(X):
        return sample_surplus_plain(X, w1, y, b1, dw, db, u_prev,
                                    shrink_factor, margin_floor)
    build.check_matrix(X)
    m, n = X.shape
    build.check_vector(w1, m, X, "w1")
    build.check_vector(y, n, X, "y")
    if u_prev is not None:
        build.check_vector(u_prev, n, X, "u_prev")
    scalars = pack_sample_scalars(b1, dw, db, shrink_factor, margin_floor,
                                  u_prev is not None, device=X.device)
    plan = column_sweep_plan(m, n, X.element_size(), bulk_aligned(X),
                             sm_count(X.device))
    f32 = dict(dtype=torch.float32, device=X.device)
    part = torch.empty(plan.scratch_shape(2), **f32)
    u = torch.empty((n,), **f32)
    surplus = torch.empty((n,), **f32)
    dev, stream = build.stream_and_device(X)
    # without history the kernel never reads u_prev; y stands in for it
    err = build.library().screen_bounds_samples(
        X.data_ptr(), int(X.dtype == torch.bfloat16), w1.data_ptr(),
        y.data_ptr(), (y if u_prev is None else u_prev).data_ptr(),
        scalars.data_ptr(), m, n, int(plan.bulk), plan.grid, plan.seg_cols,
        plan.slabs, plan.stage_rows, plan.stages, part.data_ptr(), u.data_ptr(),
        surplus.data_ptr(), dev, stream)
    build.check(err, "sample_surplus")
    LAUNCHES["sample_surplus"] += 1
    VARIANTS["sample_surplus"]["bulk" if plan.bulk else "scalar"] += 1
    return surplus, u


# -- partial modes: a sharded run all-reduces the sums between the two calls --


def screen_partial_op(X, y, theta1, weights=None) -> torch.Tensor:
    """The feature screen's partial mode: the four reductions ``[f.(y theta1),
    f.y, f.1, ||f||^2]`` (weighted by ``weights`` as the dynamic variant
    weights them) of every feature row, a (4, m) fp32 tensor, from the
    kernel's one read of X and nothing finalized. A run sharded over
    samples all-reduces them and applies :func:`screen_finalize_op`."""
    if not build.on_card(X):
        return screen_partial_plain(X, y, theta1, weights)
    build.check_matrix(X)
    m, n = X.shape
    build.check_vector(y, n, X, "y")
    build.check_vector(theta1, n, X, "theta1")
    if weights is not None:
        build.check_vector(weights, n, X, "weights")
    plan = _plan_of(X)
    f32 = dict(dtype=torch.float32, device=X.device)
    part = torch.empty(plan.scratch_shape(), **f32) if plan.segs > 1 else None
    sums = torch.empty((4, m), **f32)
    dev, stream = build.stream_and_device(X)
    err = build.library().screen_partial_features(
        X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(),
        theta1.data_ptr(), None if weights is None else weights.data_ptr(), m, n,
        int(plan.bulk), plan.grid, plan.seg_cols,
        None if part is None else part.data_ptr(), sums.data_ptr(), dev, stream)
    build.check(err, "screen_partial")
    LAUNCHES["screen_partial"] += 1
    VARIANTS["screen_partial"]["bulk" if plan.bulk else "scalar"] += 1
    return sums


def screen_finalize_op(sums, sh: ScreenShared, cap_delta=None,
                       edpp: EDPPShared = None) -> torch.Tensor:
    """Bounds (m,) from all-reduced partial sums (4, m) of either
    instantiation (weighted or not): the full launches' own finalize kernel
    (``csrc/screen.cu`` ``screen_finalize_kernel``, with the gap-sphere cap
    ``cap_delta`` or the EDPP ball ``edpp``) on the reduced sums as one
    segment, one thread a feature."""
    if not build.on_card(sums):
        return screen_finalize_plain(sums, sh, cap_delta, edpp)
    if sums.dim() != 2 or sums.shape[0] != 4 or sums.dtype != torch.float32 \
            or not sums.is_contiguous():
        raise ValueError(f"sums must be a contiguous (4, m) float32 tensor, got "
                         f"{sums.dtype} {tuple(sums.shape)}")
    m = sums.shape[1]
    scalars = pack_shared(sh, cap_delta, edpp).to(sums.device)
    bounds = torch.empty((m,), dtype=torch.float32, device=sums.device)
    dev, stream = build.stream_and_device(sums)
    err = build.library().screen_finalize_features(
        sums.data_ptr(), scalars.data_ptr(), m, int(edpp is not None),
        bounds.data_ptr(), dev, stream)
    build.check(err, "screen_finalize")
    LAUNCHES["screen_finalize"] += 1
    return bounds


def sample_partial_op(X, w1) -> torch.Tensor:
    """The sample surplus's partial mode: ``[X^T w1, column sums of X * X]``,
    a (2, n) fp32 tensor, from the kernel's sweep and slab sum, before
    ``b1`` and the finalizer. A run sharded over features all-reduces it and
    applies :func:`sample_finalize_op`."""
    if not build.on_card(X):
        return sample_partial_plain(X, w1)
    build.check_matrix(X)
    m, n = X.shape
    build.check_vector(w1, m, X, "w1")
    plan = column_sweep_plan(m, n, X.element_size(), bulk_aligned(X),
                             sm_count(X.device))
    f32 = dict(dtype=torch.float32, device=X.device)
    part = torch.empty(plan.scratch_shape(2), **f32)
    sums = torch.empty((2, n), **f32)
    dev, stream = build.stream_and_device(X)
    err = build.library().sample_partial(
        X.data_ptr(), int(X.dtype == torch.bfloat16), w1.data_ptr(), m, n,
        int(plan.bulk), plan.grid, plan.seg_cols, plan.slabs, plan.stage_rows,
        plan.stages, part.data_ptr(), sums.data_ptr(), dev, stream)
    build.check(err, "sample_partial")
    LAUNCHES["sample_partial"] += 1
    VARIANTS["sample_partial"]["bulk" if plan.bulk else "scalar"] += 1
    return sums


def sample_finalize_op(sums, y, b1, dw=float("inf"), db=float("inf"),
                       u_prev=None, shrink_factor=2.0, margin_floor=1e-3):
    """``(surplus, u)`` from all-reduced partial sums (2, n): the sample
    kernel's finalizer with one split. On an unsplit X,
    ``sample_finalize_op(sample_partial_op(X, w1), y, b1, ...)`` gives
    :func:`sample_surplus_op`'s bits."""
    if not build.on_card(sums):
        return sample_finalize_plain(sums, y, b1, dw, db, u_prev, shrink_factor,
                                     margin_floor)
    if sums.dim() != 2 or sums.shape[0] != 2 or sums.dtype != torch.float32 \
            or not sums.is_contiguous():
        raise ValueError(f"sums must be a contiguous (2, n) float32 tensor, got "
                         f"{sums.dtype} {tuple(sums.shape)}")
    n = sums.shape[1]
    build.check_vector(y, n, sums, "y")
    if u_prev is not None:
        build.check_vector(u_prev, n, sums, "u_prev")
    scalars = pack_sample_scalars(b1, dw, db, shrink_factor, margin_floor,
                                  u_prev is not None, device=sums.device)
    f32 = dict(dtype=torch.float32, device=sums.device)
    u, surplus = torch.empty((n,), **f32), torch.empty((n,), **f32)
    dev, stream = build.stream_and_device(sums)
    err = build.library().sample_finalize(
        sums.data_ptr(), n, y.data_ptr(), (y if u_prev is None else u_prev).data_ptr(),
        scalars.data_ptr(), u.data_ptr(), surplus.data_ptr(), dev, stream)
    build.check(err, "sample_finalize")
    LAUNCHES["sample_finalize"] += 1
    return surplus, u
