"""The FISTA hot loop's two O(mn) sweeps: CUDA kernels and plain versions.

* :func:`margin_obj_op` — ``u = X^T w`` (bias not added), ``xi = max(0,
  1 - y(u + b))`` and ``loss = 1/2 sum xi^2`` from one read of X.
* :func:`hinge_grad_op` — ``g = -X (y * xi)``.

Both take a host ``valid_m``: only the first ``valid_m`` rows of X are
live (the path driver's gather buffer zero-pads the rest). The margin sweep
reads only those rows (none at ``valid_m = 0``, where ``u = 0``); the
gradient writes zeros past them without reading.

Both kernels are persistent sweeps of ``csrc/sweep.cuh`` whose launch plans
are made here: the margin is a column sweep (:func:`column_sweep_plan` over
the live rows, shared with the sample surplus of ``screen.py``), the
gradient a row sweep (:func:`grad_plan`). Each has a bulk-copy variant, for
16-byte aligned rows, and a scalar one; :data:`VARIANTS` counts which ran.

For a CUDA ``X`` each wrapper checks its inputs, allocates its outputs and
scratch with ``torch.empty``, launches ``csrc/hinge.cu`` on the current
stream and counts the launch in :data:`LAUNCHES`. For a CPU ``X`` it runs
the plain version beside it. The kernels replace the reference's Pallas
``_margin_kernel`` / ``_grad_kernel`` (``repro/kernels/hinge.py``).

Both take an optional ``flag``, a 0-d int32 tensor on X's device: a launch
whose flag is 0 does no work (every block returns at once: no byte of X
read, no output written) and counts itself on the device; the caller
discards its outputs. The on-device FISTA loop (``core/solver.py``
``fista_run``) predicates the monotone restart's two sweeps on "a restart
fired", as the reference's ``lax.cond`` does, so a captured CUDA graph pays
a launch, not a read of X, on the iterations without one. The plain
versions compute their result whatever the flag, and count the calls whose
flag is 0 on the host; :func:`skipped_counts` gives both counts. Without a
flag a launch is exactly the unpredicated one.

The margin's partial mode (a sharded run, ``core/distributed.py``):
:func:`margin_partial_op` stops before the finalize and returns ``X^T w``
over the rank's rows; the caller all-reduces it over the feature axis and
:func:`margin_finalize_op` runs the kernel's finalize on the sum. On an
unsplit X the two give :func:`margin_obj_op`'s bits. The gradient needs no
mode: its rows are the rank's own.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from . import build

#: launches of each kernel in this process (reset by ``ops.reset_launch_counts``);
#: ``margin_partial`` and ``margin_finalize`` are the margin's partial mode
LAUNCHES = {"margin_obj": 0, "hinge_grad": 0, "margin_partial": 0,
            "margin_finalize": 0}
#: plain-version calls whose flag was 0 (CPU tensors); the card's predicated
#: launches that did no work are counted on the device (:func:`skipped_counts`)
SKIPPED = {"margin_obj": 0, "hinge_grad": 0}
_SKIP_SLOT = {"margin_obj": 0, "hinge_grad": 1}
_skip_dev: dict = {}  # device -> (2,) int32 counter the kernels add to
#: launches of each variant of the persistent-sweep kernels
VARIANTS = {"margin_obj": {"bulk": 0, "scalar": 0},
            "hinge_grad": {"bulk": 0, "scalar": 0},
            "margin_partial": {"bulk": 0, "scalar": 0}}

_FIN_THREADS = 256  # csrc/hinge.cu kFinThreads: columns per finalize block


def _live_rows(X: torch.Tensor, valid_m: Optional[int]) -> int:
    m = X.shape[0]
    vm = m if valid_m is None else int(valid_m)
    if not 0 <= vm <= m:
        raise ValueError(f"valid_m must be in [0, {m}], got {valid_m}")
    return vm


def _skip_counter(device: torch.device) -> torch.Tensor:
    """The device's skip counter (made on first use, which must not be
    inside a CUDA graph capture: the counter outlives every graph)."""
    key = torch.device(device.type, device.index if device.index is not None
                       else torch.cuda.current_device())
    c = _skip_dev.get(key)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the hinge kernels' skip counter must exist "
                               "before a graph capture: launch once eagerly")
        c = _skip_dev[key] = torch.zeros((2,), dtype=torch.int32, device=key)
    return c


def _flag_args(name: str, X: torch.Tensor, flag) -> tuple:
    """``(flag pointer, skip counter pointer)`` of a launch (``None`` twice
    without a flag)."""
    if flag is None:
        return None, None
    if flag.device != X.device or flag.dtype != torch.int32 or flag.numel() != 1:
        raise ValueError("flag must be a one-element int32 tensor on X's "
                         f"device, got {flag.dtype} {tuple(flag.shape)} on {flag.device}")
    return flag.data_ptr(), _skip_counter(X.device)[_SKIP_SLOT[name]:].data_ptr()


def _count_plain_skip(name: str, flag) -> None:
    if flag is not None and int(flag) == 0:  # a CPU tensor: no device sync
        SKIPPED[name] += 1


def skipped_counts() -> dict[str, int]:
    """Predicated calls that did no work, by kernel: the card's launches
    (read from each device's counter, which synchronises it) plus the plain
    versions' calls."""
    out = dict(SKIPPED)
    for c in _skip_dev.values():
        for name, slot in _SKIP_SLOT.items():
            out[name] += int(c[slot])
    return out


def reset_skipped() -> None:
    for name in SKIPPED:
        SKIPPED[name] = 0
    for c in _skip_dev.values():
        c.zero_()


def margin_partial_plain(X, w, valid_m: Optional[int] = None):
    """Plain PyTorch version of :func:`margin_partial_op`."""
    vm = _live_rows(X, valid_m)
    return torch.mv(X[:vm].float().t(), w[:vm].float())


def margin_finalize_plain(u, y, b):
    """Plain PyTorch version of :func:`margin_finalize_op`."""
    xi = torch.clamp_min(1.0 - y * (u + b), 0.0)
    return u, xi, 0.5 * torch.sum(xi * xi)


def margin_obj_plain(X, w, y, b, valid_m: Optional[int] = None):
    """Plain PyTorch version of :func:`margin_obj_op` (fp32 accumulation)."""
    return margin_finalize_plain(margin_partial_plain(X, w, valid_m), y, b)


# -- launch plans of the persistent sweeps (csrc/sweep.cuh) -------------------
# A bulk-variant block is one producer warp, which streams X into a ring of
# shared-memory stages by cp.async.bulk, and SWEEP_CONSUMERS threads that
# reduce from the ring. The scalar variant (rows not 16-byte aligned) runs
# the same walk with direct loads. The grid is a whole number of waves of
# the card's SMs; the plans depend only on the shape, the item size, the
# alignment and the SM count, so a repeated call sums in the same order.
SWEEP_CONSUMERS = 256          # csrc/sweep.cuh kConsumers
MAX_STAGES = 8                 # csrc/sweep.cuh kMaxStages
MAX_STAGE_ROWS = 8             # csrc/sweep.cuh kMaxStageRows
SMEM_PER_BLOCK = 232_448       # the most dynamic shared memory a block may use
SCALAR_BLOCKS_PER_SM = 4       # the scalar variants hold no ring
# the gradient: v = y * xi staged GRAD_V_COLS columns at a time (64 KB);
# each row read in pieces of at most GRAD_STAGE_BYTES, one piece a stage
GRAD_V_COLS = 16 * 1024
GRAD_STAGE_BYTES = 32 * 1024
GRAD_STAGES = 4
# the column sweep: a segment row is up to COLUMN_UNITS 16-byte units a
# consumer thread (csrc/hinge.cu and csrc/sample.cu instantiate 1, 2 and
# 4), its width a multiple of 128 bytes; a stage holds up to
# COLUMN_STAGE_BYTES of segment rows (at most MAX_STAGE_ROWS). Chosen on an
# H100 at 50,000 x 10,000 fp32 with scripts/torch_sweep_tune.py: for the
# sample surplus 4 units and 48 KB stages ran 7% faster than 1 unit and
# 32 KB; the margin shares them: they ran 0.651 ms against 0.684 for 1 unit
# and 32 KB, and its best choice (64 KB stages, 3 stages: 0.649 ms; bf16
# 0.346 against 0.348) was less than 1% faster.
COLUMN_UNITS = 4
COLUMN_STAGE_BYTES = 48 * 1024
COLUMN_STAGES = 4
COLUMN_SEG_ALIGN = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def split_start(i: int, total: int, parts: int) -> int:
    """Start of run ``i`` when ``total`` items are cut into ``parts``
    consecutive runs whose lengths differ by at most one (csrc/sweep.cuh
    ``split_start``)."""
    q, r = divmod(total, parts)
    return i * q + min(i, r)


def rows_aligned(address: int, n: int, itemsize: int) -> bool:
    """True when every row of an (m, n) row-major array at ``address``
    starts on a 16-byte boundary, the condition of the bulk copies: the base
    address and the row length in bytes are multiples of 16 (fp32
    n % 4 == 0, bf16 n % 8 == 0)."""
    return address % 16 == 0 and (n * itemsize) % 16 == 0


def bulk_aligned(X: torch.Tensor) -> bool:
    return rows_aligned(X.data_ptr(), X.shape[1], X.element_size())


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class GradPlan(NamedTuple):
    """How ``hinge_grad_op`` cuts ``g = -X v``: block ``b`` owns the live
    rows :meth:`rows` (a tile is one row); every row is read in the column
    pieces :meth:`pieces`, in that order. ``v`` is staged ``chunk_cols``
    columns at a time; a bulk-variant ring stage holds one piece."""

    bulk: bool
    grid: int
    valid_m: int
    n: int
    itemsize: int
    chunk_cols: int
    piece_cols: int
    stages: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a block takes (csrc/hinge.cu GradSmem)."""
        if not self.bulk:
            return self.chunk_cols * 4
        v = 16 * MAX_STAGES + 2 * (SWEEP_CONSUMERS // 32) * 4  # barriers, row sums
        ring = _round_up(v + self.chunk_cols * 4, 128)
        return ring + self.stages * _round_up(self.piece_cols * self.itemsize, 128)

    def rows(self, b: int) -> range:
        return range(split_start(b, self.valid_m, self.grid),
                     split_start(b + 1, self.valid_m, self.grid))

    def pieces(self) -> list[tuple[int, int]]:
        out = []
        for c0 in range(0, self.n, self.chunk_cols):
            c1 = min(c0 + self.chunk_cols, self.n)
            out += [(p, min(p + self.piece_cols, c1))
                    for p in range(c0, c1, self.piece_cols)]
        return out


@functools.lru_cache(maxsize=256)
def grad_plan(valid_m: int, n: int, itemsize: int, aligned: bool,
              sms: int) -> GradPlan:
    """The gradient sweep's plan (see :class:`GradPlan`). Bulk variant: one
    block per SM (its ring and v take ~120 KB of shared memory at n =
    10,000 fp32); scalar variant: :data:`SCALAR_BLOCKS_PER_SM`."""
    vec = 16 // itemsize
    grid = sms * (1 if aligned else SCALAR_BLOCKS_PER_SM)
    chunk = _round_up(_cdiv(n, _cdiv(n, GRAD_V_COLS)), vec)
    piece = chunk
    if aligned:
        piece = _round_up(_cdiv(chunk, _cdiv(chunk * itemsize, GRAD_STAGE_BYTES)), vec)
    return GradPlan(aligned, grid, valid_m, n, itemsize, chunk, piece, GRAD_STAGES)


class ColumnSweepPlan(NamedTuple):
    """How a column-reduction sweep (the margin over the live rows, the
    sample surplus over all rows) cuts X's first ``m`` rows: ``segs``
    column segments of ``seg_cols`` columns (COLUMN_UNITS x 16 bytes a
    consumer thread) times ``slabs`` row slabs whose sizes differ by at
    most one row. Tile ``t`` is segment
    ``t // slabs``, slab ``t % slabs``; block ``b`` takes the consecutive
    tiles :meth:`tiles_of`. Slab ``s`` writes its partial column sums to row
    ``s`` of the scratch, and a finalizer sums the slabs in order. A ring
    stage holds ``stage_rows`` segment rows of one tile."""

    bulk: bool
    grid: int
    m: int
    n: int
    itemsize: int
    seg_cols: int
    slabs: int
    stage_rows: int
    stages: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a block takes (csrc/sweep.cuh
        column_smem_bytes)."""
        if not self.bulk:
            return 0
        return 16 * MAX_STAGES + self.stages * self.stage_rows * self.seg_cols * self.itemsize

    @property
    def segs(self) -> int:
        return _cdiv(self.n, self.seg_cols)

    @property
    def tiles(self) -> int:
        return self.segs * self.slabs

    def tiles_of(self, b: int) -> range:
        return range(split_start(b, self.tiles, self.grid),
                     split_start(b + 1, self.tiles, self.grid))

    def scratch_shape(self, accumulators: int) -> tuple[int, int]:
        """Shape of the fp32 partials of a sweep that carries
        ``accumulators`` sums a column: one row per slab and sum."""
        return (accumulators * self.slabs, self.n)

    def tile(self, t: int) -> tuple[range, range]:
        """(rows, columns) of tile ``t``."""
        c, s = divmod(t, self.slabs)
        c0 = c * self.seg_cols
        return (range(split_start(s, self.m, self.slabs),
                      split_start(s + 1, self.m, self.slabs)),
                range(c0, min(c0 + self.seg_cols, self.n)))


@functools.lru_cache(maxsize=256)
def column_sweep_plan(m: int, n: int, itemsize: int, aligned: bool,
                      sms: int) -> ColumnSweepPlan:
    """The column sweep's plan (see :class:`ColumnSweepPlan`) over X's
    first ``m`` rows: the live rows for the margin (``m = 0`` gives tiles of
    no rows, so nothing is read), all rows for the sample surplus. The slab
    count is the least that makes the tile count a multiple of the grid, so
    every block takes the same number of tiles, unless m has too few rows
    for it (then the counts differ by at most one). The scalar variant
    takes one 16-byte unit a thread."""
    units = COLUMN_UNITS if aligned else 1
    grid = sms * (1 if aligned else SCALAR_BLOCKS_PER_SM)
    align = (COLUMN_SEG_ALIGN if aligned else 16) // itemsize
    seg = _round_up(_cdiv(n, _cdiv(n * itemsize, units * 16 * SWEEP_CONSUMERS)), align)
    seg = min(seg, units * 16 * SWEEP_CONSUMERS // itemsize)
    segs = _cdiv(n, seg)
    slabs = max(1, min(grid // math.gcd(grid, segs), m // MAX_STAGE_ROWS))
    rows = max(1, min(MAX_STAGE_ROWS, COLUMN_STAGE_BYTES // (seg * itemsize)))
    return ColumnSweepPlan(aligned, grid, m, n, itemsize, seg, slabs, rows,
                           COLUMN_STAGES)


def margin_obj_op(X, w, y, b, valid_m: Optional[int] = None, flag=None,
                  out=None):
    """``(u, xi, loss)`` from one sweep of X's first ``valid_m`` rows.

    ``X`` (m, n) fp32/bf16; ``w`` (m,) and ``y`` (n,) fp32; ``b`` a 0-d fp32
    tensor on X's device or a number. Returns ``u``, ``xi`` (n,) fp32 and a
    0-d fp32 ``loss``, all on X's device. ``flag``: the launch's predicate
    (see the module docstring); ``out``: ``(u, xi, loss)`` to write into
    instead of new tensors. No caller in the package passes ``out``: it
    is there for the card test that a switched-off launch leaves its
    outputs as they were (``tests/test_torch_kernels.py``).
    """
    if not build.on_card(X):
        _count_plain_skip("margin_obj", flag)
        return margin_obj_plain(X, w, y, b, valid_m)
    build.check_matrix(X)
    m, n = X.shape
    vm = _live_rows(X, valid_m)
    build.check_vector(w, m, X, "w")
    build.check_vector(y, n, X, "y")
    b = torch.as_tensor(b, dtype=torch.float32, device=X.device)
    if b.dim() != 0:
        raise ValueError(f"b must be a scalar, got shape {tuple(b.shape)}")
    plan = column_sweep_plan(vm, n, X.element_size(), bulk_aligned(X),
                             sm_count(X.device))
    f32 = dict(dtype=torch.float32, device=X.device)
    part = torch.empty(plan.scratch_shape(1), **f32)
    if out is None:
        u, xi, loss = (torch.empty((n,), **f32), torch.empty((n,), **f32),
                       torch.empty((), **f32))
    else:
        u, xi, loss = out
        for v, size, name in ((u, n, "u"), (xi, n, "xi")):
            build.check_vector(v, size, X, name)
        if loss.device != X.device or loss.dtype != torch.float32 or loss.dim():
            raise ValueError("loss must be a 0-d float32 tensor on X's device")
    loss_part = torch.empty((_cdiv(n, _FIN_THREADS),), **f32)
    flag_p, skip_p = _flag_args("margin_obj", X, flag)
    dev, stream = build.stream_and_device(X)
    err = build.library().margin_obj(
        X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(),
        y.data_ptr(), b.data_ptr(), n, vm, int(plan.bulk), plan.grid,
        plan.seg_cols, plan.slabs, plan.stage_rows, plan.stages,
        part.data_ptr(), u.data_ptr(), xi.data_ptr(), loss_part.data_ptr(),
        loss.data_ptr(), flag_p, skip_p, dev, stream)
    build.check(err, "margin_obj")
    LAUNCHES["margin_obj"] += 1
    VARIANTS["margin_obj"]["bulk" if plan.bulk else "scalar"] += 1
    return u, xi, loss


def hinge_grad_plain(X, y, xi, valid_m: Optional[int] = None):
    """Plain PyTorch version of :func:`hinge_grad_op` (fp32 accumulation)."""
    vm = _live_rows(X, valid_m)
    g = torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
    g[:vm] = -torch.mv(X[:vm].float(), y * xi)
    return g


def hinge_grad_op(X, y, xi, valid_m: Optional[int] = None, flag=None,
                  out=None):
    """``g = -X (y * xi)`` over X's first ``valid_m`` rows, zeros past them.

    ``X`` (m, n) fp32/bf16; ``y``, ``xi`` (n,) fp32. Returns (m,) fp32.
    ``flag`` and ``out`` (an (m,) fp32 ``g``) as for :func:`margin_obj_op`.
    """
    if not build.on_card(X):
        _count_plain_skip("hinge_grad", flag)
        return hinge_grad_plain(X, y, xi, valid_m)
    build.check_matrix(X)
    m, n = X.shape
    vm = _live_rows(X, valid_m)
    build.check_vector(y, n, X, "y")
    build.check_vector(xi, n, X, "xi")
    plan = grad_plan(vm, n, X.element_size(), bulk_aligned(X), sm_count(X.device))
    if out is None:
        g = torch.empty((m,), dtype=torch.float32, device=X.device)
    else:
        g = out
        build.check_vector(g, m, X, "g")
    flag_p, skip_p = _flag_args("hinge_grad", X, flag)
    dev, stream = build.stream_and_device(X)
    err = build.library().hinge_grad(
        X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(),
        xi.data_ptr(), m, n, vm, int(plan.bulk), plan.grid, plan.chunk_cols,
        plan.piece_cols, plan.stages, g.data_ptr(), flag_p, skip_p, dev, stream)
    build.check(err, "hinge_grad")
    LAUNCHES["hinge_grad"] += 1
    VARIANTS["hinge_grad"]["bulk" if plan.bulk else "scalar"] += 1
    return g


def margin_partial_op(X, w, valid_m: Optional[int] = None, flag=None):
    """The margin's partial mode: ``u_part = X^T w`` over X's first
    ``valid_m`` rows, (n,) fp32, before the bias and the finalize. A sharded
    run all-reduces it over the feature axis and finalizes with
    :func:`margin_finalize_op`. The sweep and the slab sum are
    :func:`margin_obj_op`'s. ``flag`` as for :func:`margin_obj_op`."""
    if not build.on_card(X):
        _count_plain_skip("margin_obj", flag)
        return margin_partial_plain(X, w, valid_m)
    build.check_matrix(X)
    m, n = X.shape
    vm = _live_rows(X, valid_m)
    build.check_vector(w, m, X, "w")
    plan = column_sweep_plan(vm, n, X.element_size(), bulk_aligned(X),
                             sm_count(X.device))
    f32 = dict(dtype=torch.float32, device=X.device)
    part = torch.empty(plan.scratch_shape(1), **f32)
    u_part = torch.empty((n,), **f32)
    flag_p, skip_p = _flag_args("margin_obj", X, flag)
    dev, stream = build.stream_and_device(X)
    err = build.library().margin_partial(
        X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(), n, vm,
        int(plan.bulk), plan.grid, plan.seg_cols, plan.slabs, plan.stage_rows,
        plan.stages, part.data_ptr(), u_part.data_ptr(), flag_p, skip_p, dev,
        stream)
    build.check(err, "margin_partial")
    LAUNCHES["margin_partial"] += 1
    VARIANTS["margin_partial"]["bulk" if plan.bulk else "scalar"] += 1
    return u_part


def margin_finalize_op(u, y, b, flag=None):
    """The finalize of :func:`margin_obj_op` on all-reduced margins ``u``
    (n,) fp32: ``(u, xi, loss)`` with the kernel's own arithmetic and loss
    sum. On an unsplit X, ``margin_finalize_op(margin_partial_op(X, w), y,
    b)`` gives :func:`margin_obj_op`'s bits. ``flag``: the launch's
    predicate (a switched-off launch writes nothing)."""
    if not build.on_card(u):
        return margin_finalize_plain(u, y, b)
    n = u.shape[0]
    build.check_vector(u, n, u, "u")
    build.check_vector(y, n, u, "y")
    b = torch.as_tensor(b, dtype=torch.float32, device=u.device)
    if b.dim() != 0:
        raise ValueError(f"b must be a scalar, got shape {tuple(b.shape)}")
    f32 = dict(dtype=torch.float32, device=u.device)
    u_out, xi, loss = (torch.empty((n,), **f32), torch.empty((n,), **f32),
                       torch.empty((), **f32))
    loss_part = torch.empty((_cdiv(n, _FIN_THREADS),), **f32)
    if flag is not None and (flag.device != u.device or flag.dtype != torch.int32):
        raise ValueError("flag must be an int32 tensor on u's device")
    dev, stream = build.stream_and_device(u)
    err = build.library().margin_finalize(
        u.data_ptr(), y.data_ptr(), b.data_ptr(), n, u_out.data_ptr(),
        xi.data_ptr(), loss_part.data_ptr(), loss.data_ptr(),
        None if flag is None else flag.data_ptr(), dev, stream)
    build.check(err, "margin_finalize")
    LAUNCHES["margin_finalize"] += 1
    return u_out, xi, loss
