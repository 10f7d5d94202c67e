"""2-D sharded screening and FISTA over ``torch.distributed`` (features x
samples grid).

Port of the reference ``core/distributed.py``. X's feature rows are split
over a "model" axis and its sample columns over a "data" axis: rank ``r``
of a ``model x data`` grid sits at ``(i, j) = (r // data, r % data)`` and
holds the block ``X[i m/M : (i+1) m/M, j n/D : (j+1) n/D]``, with its
columns of ``y`` and ``theta`` and its rows of ``w``, the bounds and the
keep masks. The split must be even: zero padding would change ``n``.

Communication (the paper's O(mn) screen on the grid):

* the feature screen's four per-feature reductions are summed over "data"
  (the screen kernel's partial mode, then one all-reduce of ``4 m/M``
  floats), then bounded on the rank's rows with the kernel's own finalize;
* FISTA: margins are summed over "model" (the margin kernel's partial mode
  and finalize), gradients over "data";
* the sample rule's two column sums over "model" (the sample kernel's
  partial mode and finalizer).

The reference runs one process driving a JAX mesh; here every rank is a
process of a ``torch.distributed`` group and runs the same program on its
block (SPMD). :func:`svm_grid` builds the axis groups, :func:`grid_collectives`
binds the solver's :class:`~repro_torch.core.solver.Collectives` seam to
``all_reduce`` over them; an axis of size 1 binds to the identity, so a
``1 x 1`` grid is the local program bit for bit. Every decision that ends a
loop or picks a branch is taken from all-reduced values, which every rank of
an axis receives bit for bit alike.

Backends: the caller's process group decides. ``nccl`` needs a GPU per
rank; ranks that share one card use ``gloo`` over CUDA tensors (gloo stages
them through the host and offers ``all_reduce``, which is all the seam
uses); the tests use ``gloo`` on the CPU. :func:`run_grid` spawns the ranks
of one grid, rendezvous through a ``file://`` store in a temporary
directory. :data:`ALLREDUCE` counts the all-reduces of this process and
their bytes.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..kernels.ops import sample_finalize_op, sample_partial_op, sample_surplus_op
from .dual import bias_at_lambda_max_sharded
from .screening import SAFE_TAU, _scalar, shared_scalars_from_stats
from .solver import (
    LOCAL,
    Collectives,
    DynamicFistaResult,
    _identity,
    fista_run,
    fista_run_dynamic,
    lipschitz_estimate,
    region_stats,
    seam_screen_bounds,
)

__all__ = [
    "SvmGrid",
    "svm_grid",
    "grid_collectives",
    "screen_sharded",
    "sample_surplus_sharded",
    "fista_sharded",
    "sample_violators_sharded",
    "gather_rows",
    "gather_cols",
    "rank0_value",
    "run_grid",
    "ALLREDUCE",
    "GROUP_TIMEOUT_S",
]

#: all-reduces of this process: calls and bytes
ALLREDUCE = {"calls": 0, "bytes": 0}
#: the process groups' timeout: a rank that diverges fails the run, it does
#: not hang it
GROUP_TIMEOUT_S = 90.0
#: the thread pools of a spawned rank, one thread each as torch's
#: (``torch.set_num_threads(1)``): ranks that share a host must not
#: oversubscribe its cores, and a numpy BLAS call's pool spins on the idle
#: ones for a while after it returns (the environment is read at import)
RANK_THREAD_ENV = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                   "MKL_NUM_THREADS")}


@dataclass
class SvmGrid:
    """A rank's place on a ``model x data`` grid and its two axis groups
    (``None`` for an axis of size 1)."""

    model: int
    data: int
    rank: int
    model_group: Any = None
    data_group: Any = None
    backend: str = "local"
    col: Collectives = field(default=LOCAL, repr=False)

    @property
    def i(self) -> int:
        return self.rank // self.data

    @property
    def j(self) -> int:
        return self.rank % self.data

    def _span(self, total: int, parts: int, k: int, what: str) -> tuple[int, int]:
        if total % parts:
            raise ValueError(f"{what} {total} does not split evenly over {parts} "
                             "ranks (padding would change the problem)")
        step = total // parts
        return k * step, (k + 1) * step

    def rows(self, m: int) -> tuple[int, int]:
        """The rank's feature rows ``[r0, r1)`` of an m-row X."""
        return self._span(m, self.model, self.i, "m")

    def cols(self, n: int) -> tuple[int, int]:
        """The rank's sample columns ``[c0, c1)`` of an n-column X."""
        return self._span(n, self.data, self.j, "n")

    def block(self, X):
        """The rank's block of a whole X (numpy or tensor; a view)."""
        r0, r1 = self.rows(X.shape[0])
        c0, c1 = self.cols(X.shape[1])
        return X[r0:r1, c0:c1]

    def row_block(self, v):
        """The rank's rows of a feature-axis vector (last axis)."""
        r0, r1 = self.rows(v.shape[-1])
        return v[..., r0:r1]

    def col_block(self, v):
        """The rank's columns of a sample-axis vector (last axis)."""
        c0, c1 = self.cols(v.shape[-1])
        return v[..., c0:c1]

    def shape(self, X_blk) -> tuple[int, int]:
        """``(m, n)`` of the whole X from the rank's block."""
        return X_blk.shape[0] * self.model, X_blk.shape[1] * self.data


def _reducer(group, op) -> Callable:
    def reduce(x: torch.Tensor) -> torch.Tensor:
        t = x.detach().reshape(-1).clone()
        dist.all_reduce(t, op=op, group=group)
        ALLREDUCE["calls"] += 1
        ALLREDUCE["bytes"] += t.numel() * t.element_size()
        return t.reshape(x.shape)
    return reduce


def svm_grid(model: int, data: int, group=None) -> SvmGrid:
    """This process's place on a ``model x data`` grid of the ranks of
    ``group`` (default: the world), with its axis groups (the reference's
    ``svm_mesh``). Every rank must call it, in the same order: it creates
    every model group (ranks of one column block, the same ``j``) and every
    data group (the same ``i``) with ``new_group``. A ``1 x 1`` grid needs
    no process group."""
    if model < 1 or data < 1:
        raise ValueError(f"grid must be at least 1 x 1, got {model} x {data}")
    if model * data == 1:
        return SvmGrid(1, 1, 0)
    world = dist.get_world_size(group)
    if world != model * data:
        raise ValueError(f"a {model} x {data} grid needs {model * data} ranks, "
                         f"the group has {world}")
    rank = dist.get_rank(group)
    ranks = (list(range(world)) if group is None
             else dist.get_process_group_ranks(group))
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    grid = SvmGrid(model, data, rank, backend=dist.get_backend(group))
    for jj in range(data):  # model groups: one per column block
        g = dist.new_group([ranks[ii * data + jj] for ii in range(model)],
                           timeout=timeout)
        if model > 1 and jj == grid.j:
            grid.model_group = g
    for ii in range(model):  # data groups: one per row block
        g = dist.new_group([ranks[ii * data + jj] for jj in range(data)],
                           timeout=timeout)
        if data > 1 and ii == grid.i:
            grid.data_group = g
    grid.col = grid_collectives(grid)
    return grid


def grid_collectives(grid: SvmGrid) -> Collectives:
    """The solver's seam bound to ``all_reduce`` over the grid's axes (the
    reference's ``mesh_collectives``): SUM over the model group for margins
    and ``sum |w|``, SUM over the data group for gradients, losses and the
    bias gradient, MAX over the model group. An axis of size 1 binds to the
    identity, so a ``1 x 1`` grid is :data:`~repro_torch.core.solver.LOCAL`.

    The bias gradient: every model row of the grid holds the same slacks,
    so their sum over the data group is the global one; the reference sums
    over both axes and divides by the model count, which rounds differently
    (ROADMAP queue 3)."""
    if grid.model == 1 and grid.data == 1:
        return LOCAL
    SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX
    psum_model = _reducer(grid.model_group, SUM) if grid.model > 1 else _identity
    psum_data = _reducer(grid.data_group, SUM) if grid.data > 1 else _identity
    pmax_model = _reducer(grid.model_group, MAX) if grid.model > 1 else _identity
    return Collectives(psum_model, psum_data, psum_data, pmax_model)


def _gather(v_blk: torch.Tensor, parts: int, k: int, psum) -> torch.Tensor:
    """Block ``k`` of ``parts`` along the last axis, zero-padded to the whole
    axis and all-reduced: every rank of the axis gets the whole vector."""
    if parts == 1:
        return v_blk
    size = v_blk.shape[-1]
    full = torch.zeros((*v_blk.shape[:-1], size * parts), dtype=v_blk.dtype,
                       device=v_blk.device)
    full[..., k * size:(k + 1) * size] = v_blk
    return psum(full)


def gather_rows(grid: SvmGrid, v_blk: torch.Tensor) -> torch.Tensor:
    """The whole feature-axis vector(s) from the ranks' row blocks (last
    axis), over the model group."""
    return _gather(v_blk, grid.model, grid.i, grid.col.psum_model)


def gather_cols(grid: SvmGrid, v_blk: torch.Tensor) -> torch.Tensor:
    """The whole sample-axis vector(s) from the ranks' column blocks (last
    axis), over the data group."""
    return _gather(v_blk, grid.data, grid.j, grid.col.psum_data)


def rank0_value(grid: SvmGrid, v: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``v`` on every rank: ``v`` on rank 0 and zeros elsewhere,
    summed over the model axis, then over the data axis. A decision that
    reads a rank's own clock is made on rank 0 and agreed this way."""
    col = grid.col
    v = v if grid.rank == 0 else torch.zeros_like(v)
    return col.psum_data(col.psum_model(v))


def screen_sharded(grid: SvmGrid, X, y, lam1, lam2, theta1, tau: float = SAFE_TAU,
                   *, delta):
    """Safe feature screening on the grid (reference ``screen_sharded``):
    ``(keep, bounds)`` of the rank's rows.

    ``X``, ``y`` and ``theta1`` are the rank's blocks. On a grid that keeps
    the sample axis whole (``data == 1``) each rank launches the feature
    screen on its rows with the region's scalars, which are global there:
    the bounds are the single-device kernel's bit for bit (a row's sums do
    not depend on m). Otherwise the screen's partial mode, the all-reduce of
    the four sums over "data", the region's scalars from all-reduced
    statistics (``solver.region_stats``, delta-inflated) and the kernel's
    finalize: ``solver.seam_screen_bounds``, as the scan engine's screen and
    the dynamic refresh take it. ``delta`` bounds ``||theta1 - theta*(lam1)||``
    and is required: a sharded screen that assumed an exact anchor could
    discard unsafely. The keep test is NaN-safe."""
    col = grid.col
    sh = shared_scalars_from_stats(_scalar(lam1, theta1), _scalar(lam2, theta1),
                                   **region_stats(y, theta1, col),
                                   delta=_scalar(delta, theta1))
    bounds = seam_screen_bounds(X, y, theta1, sh, col)
    return ~(bounds < tau), bounds


def sample_surplus_sharded(grid: SvmGrid, X, y, w, b, dw=float("inf"),
                           db=float("inf"), u_prev: Optional[torch.Tensor] = None,
                           shrink_factor: float = 2.0, margin_floor: float = 1e-3):
    """The sample rule's margin sweep on the grid (reference
    ``sample_surplus_sharded``): ``(surplus, u1)`` of the rank's columns.

    ``X`` the rank's block, ``y`` and ``u_prev`` its columns, ``w`` its
    rows. On a grid that keeps the feature axis whole (``model == 1``) the
    full launch of the sample kernel: the local kernel's bits. Otherwise the
    kernel's partial mode (``[x.w, ||x||^2]`` over the rank's rows), the
    all-reduce over "model" and the kernel's own finalizer on the sums."""
    col = grid.col
    if col.psum_model is _identity:
        return sample_surplus_op(X, w, y, b, dw, db, u_prev, shrink_factor,
                                 margin_floor)
    sums = col.psum_model(sample_partial_op(X, w))
    return sample_finalize_op(sums, y, b, dw, db, u_prev, shrink_factor, margin_floor)


def sample_violators_sharded(grid: SvmGrid, X, y, rules) -> Callable:
    """The verification of ``rules`` (sample rules with ``verify``) on the
    grid, for ``rules.base.solve_with_verification``: a function ``(w, b,
    screened) -> violators`` of host sample indices of the whole X, the same
    on every rank. Each rank tests the screened samples of its columns with
    its rows' float64 partial margins, summed over "model" in float64
    (``SampleVIRule.verify(col=)``); the violators are gathered over
    "data"."""
    n_loc = y.shape[0]
    c0 = grid.j * n_loc

    def find(w, b, screened: np.ndarray) -> np.ndarray:
        mine = screened[(screened >= c0) & (screened < c0 + n_loc)] - c0
        flags = torch.zeros((n_loc,), dtype=torch.float32, device=y.device)
        if len(mine):  # the same columns, so the same test, on a model group
            idx = torch.from_numpy(mine).to(y.device)
            for rule in rules:
                flags[rule.verify(X, y, w, b, idx, col=grid.col)] = 1.0
        flags = gather_cols(grid, flags)
        return np.nonzero(flags.cpu().numpy() > 0.5)[0]

    return find


def fista_sharded(grid: SvmGrid, X, y, lam, max_iters: int = 2000, tol: float = 1e-9,
                  w0: Optional[torch.Tensor] = None, b0=None,
                  sample_mask: Optional[torch.Tensor] = None,
                  feature_mask: Optional[torch.Tensor] = None,
                  screen_every: Optional[int] = None, tau: float = SAFE_TAU,
                  n_feas_iters: int = 4, L=None):
    """FISTA on the grid (reference ``fista_sharded``), through
    ``solver.fista_run`` (static) or ``solver.fista_run_dynamic``
    (``screen_every``: the in-solver gap-certified re-screen) with the
    grid's seam: no third FISTA loop.

    ``X`` the rank's block; ``y``, ``sample_mask`` its columns; ``w0``,
    ``feature_mask`` its rows (zeros of ``feature_mask`` stay zero). ``L``
    a known Lipschitz bound (a path estimates it once), else the sharded
    power iteration. ``b0`` defaults to the global mean of y. Returns a
    :class:`~repro_torch.core.solver.FistaResult` (``w`` the rank's rows,
    scalars as host numbers), with ``screen_every`` a
    :class:`~repro_torch.core.solver.DynamicFistaResult` whose kept counts
    are global. The reference's body has no guard and certifies with 4
    feasibility rounds; here the guard is on (ROADMAP queue 3)."""
    col = grid.col
    m_loc, n_loc = X.shape
    dev = X.device
    fm = (torch.ones((m_loc,), dtype=X.dtype, device=dev) if feature_mask is None
          else feature_mask.to(device=dev, dtype=X.dtype))
    if w0 is None:
        w0 = torch.zeros((m_loc,), dtype=X.dtype, device=dev)
    if b0 is None:
        b0 = bias_at_lambda_max_sharded(y, col, n_loc * grid.data)
    if L is None:
        L = lipschitz_estimate(X, col=col, cols=(grid.j * n_loc, n_loc * grid.data))
    L = torch.as_tensor(L, device=dev).to(torch.float32)
    inv_L = 1.0 / torch.clamp_min(L * 1.01, 1e-12)
    if screen_every is None:
        res = fista_run(X, y, lam, w0 * fm, b0, inv_L, sample_mask, fm, max_iters,
                        tol, col=col)
        return res._replace(obj=float(res.obj), n_iters=int(res.n_iters),
                            converged=bool(res.converged), health=int(res.health))
    tele: dict = {}
    res = fista_run_dynamic(X, y, lam, w0, b0, inv_L, sample_mask, fm, max_iters, tol,
                            int(screen_every), tau, n_feas_iters, col=col,
                            telemetry=tele)
    kept = np.asarray(tele.get("kept_per_segment", []), np.int64)
    return DynamicFistaResult(
        w=res.w, b=res.b, obj=float(res.obj), n_iters=int(res.n_iters),
        converged=bool(res.converged), feature_mask=tele["feature_mask"],
        kept_per_segment=kept,
        gap_per_segment=np.asarray(tele.get("gap_per_segment", []), np.float64),
        n_segments=len(kept), u=res.u, health=int(res.health))


# -- ranks ------------------------------------------------------------------------


def _rank_main(rank: int, fn, model: int, data: int, backend: str, device: str,
               tmp: str, arrays: dict, args: tuple) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0 if backend == "gloo" else rank)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank,
        world_size=model * data, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        grid = svm_grid(model, data)
        data_in = {k: np.load(path, mmap_mode="r") for k, path in arrays.items()}
        out = fn(grid, data_in, *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".part", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".part", path)
    finally:
        dist.destroy_process_group()


def run_grid(fn, model: int, data: int, arrays: Optional[dict] = None,
             args: tuple = (), backend: str = "gloo", device: str = "cuda",
             timeout: float = 600.0) -> list:
    """Runs ``fn(grid, arrays, *args)`` on the ``model * data`` ranks of a
    new grid, spawned processes (``torch.multiprocessing``) that meet
    through a ``file://`` store in a temporary directory, and returns what
    each rank's ``fn`` returned (pickled), in rank order.

    ``arrays`` (name -> numpy array, or the path of a ``.npy`` file) are
    saved there once (a path is used as it is); each rank gets them
    memory-mapped (``np.load(mmap_mode="r")``) and copies its block.
    ``fn`` must be a module-level function. ``backend`` is ``"gloo"`` (CPU
    tensors, or ranks sharing one GPU) or ``"nccl"`` (a GPU per rank).
    ``device`` is the ranks' (the card unless ``"cpu"`` is asked for; it
    raises without one, as every entry point does).
    CUDA ranks load the kernel library the caller built (call
    ``kernels.build.library()`` first); they do not build it. A rank that
    raises fails the call; so does one still running after ``timeout``
    seconds (all ranks are then killed). Each rank runs its thread pools
    (torch's, OpenMP's, BLAS's) on one thread (:data:`RANK_THREAD_ENV`)."""
    device = resolve_device(device).type
    world = model * data
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for k, v in (arrays or {}).items():
            if isinstance(v, (str, os.PathLike)):
                paths[k] = str(v)
            else:
                paths[k] = os.path.join(tmp, f"{k}.npy")
                np.save(paths[k], np.asarray(v))
        saved = {k: os.environ.get(k) for k in RANK_THREAD_ENV}
        os.environ.update(RANK_THREAD_ENV)  # the children's, restored below
        try:
            ctx = torch.multiprocessing.start_processes(
                _rank_main, args=(fn, model, data, backend, device, tmp, paths,
                                  tuple(args)),
                nprocs=world, join=False, start_method="spawn")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"grid {model} x {data}: ranks still running "
                                       f"after {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
