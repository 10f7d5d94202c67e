"""The FISTA hot loop's two O(mn) sweeps: CUDA kernels and plain versions.

* :func:`margin_obj_op` — ``u = X^T w`` (bias not added), ``xi = max(0,
  1 - y(u + b))`` and ``loss = 1/2 sum xi^2`` from one read of X.
* :func:`hinge_grad_op` — ``g = -X (y * xi)``.

Both take a host ``valid_m``: only the first ``valid_m`` rows of X are
live (the path driver's gather buffer zero-pads the rest). The margin sweep
reads only those rows; the gradient writes zeros past them without reading.

For a CUDA ``X`` each wrapper checks its inputs, allocates its outputs and
scratch with ``torch.empty``, launches ``csrc/hinge.cu`` on the current
stream and counts the launch in :data:`LAUNCHES`. For a CPU ``X`` it runs
the plain version beside it. The kernels replace the reference's Pallas
``_margin_kernel`` / ``_grad_kernel`` (``repro/kernels/hinge.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build

#: launches of each kernel in this process (reset by ``ops.reset_launch_counts``)
LAUNCHES = {"margin_obj": 0, "hinge_grad": 0}

_MARGIN_THREADS = 256     # csrc/hinge.cu kMarginThreads (= kFinThreads)
_BLOCKS_PER_SM = 4        # margin partial blocks to aim for on each SM
_MIN_ROWS_PER_SPLIT = 64  # below this a split costs more than it spreads


def _live_rows(X: torch.Tensor, valid_m: Optional[int]) -> int:
    m = X.shape[0]
    vm = m if valid_m is None else int(valid_m)
    if not 0 <= vm <= m:
        raise ValueError(f"valid_m must be in [0, {m}], got {valid_m}")
    return vm


def margin_obj_plain(X, w, y, b, valid_m: Optional[int] = None):
    """Plain PyTorch version of :func:`margin_obj_op` (fp32 accumulation)."""
    vm = _live_rows(X, valid_m)
    u = torch.mv(X[:vm].float().t(), w[:vm].float())
    xi = torch.clamp_min(1.0 - y * (u + b), 0.0)
    return u, xi, 0.5 * torch.sum(xi * xi)


def margin_splits(valid_m: int, n: int, device: torch.device) -> tuple[int, int]:
    """``(rows_per_split, splits)``: how a column-reduction kernel (the
    margin sweep here, the sample sweep in ``screen.py``) cuts the live rows
    across ``blockIdx.y`` so the card holds ~4 blocks per SM. Depends only
    on the shape and the card, so repeated calls sum in the same order."""
    col_blocks = -(-n // _MARGIN_THREADS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-_BLOCKS_PER_SM * sms // col_blocks))
    splits = max(1, min(want, valid_m // _MIN_ROWS_PER_SPLIT))
    rows_per_split = max(1, -(-valid_m // splits))
    return rows_per_split, max(1, -(-valid_m // rows_per_split))


def margin_obj_op(X, w, y, b, valid_m: Optional[int] = None):
    """``(u, xi, loss)`` from one sweep of X's first ``valid_m`` rows.

    ``X`` (m, n) fp32/bf16; ``w`` (m,) and ``y`` (n,) fp32; ``b`` a 0-d fp32
    tensor on X's device or a number. Returns ``u``, ``xi`` (n,) fp32 and a
    0-d fp32 ``loss``, all on X's device.
    """
    if not build.on_card(X):
        return margin_obj_plain(X, w, y, b, valid_m)
    build.check_matrix(X)
    m, n = X.shape
    vm = _live_rows(X, valid_m)
    build.check_vector(w, m, X, "w")
    build.check_vector(y, n, X, "y")
    b = torch.as_tensor(b, dtype=torch.float32, device=X.device)
    if b.dim() != 0:
        raise ValueError(f"b must be a scalar, got shape {tuple(b.shape)}")
    rows_per_split, splits = margin_splits(vm, n, X.device)
    f32 = dict(dtype=torch.float32, device=X.device)
    part = torch.empty((splits, n), **f32)
    u = torch.empty((n,), **f32)
    xi = torch.empty((n,), **f32)
    loss_part = torch.empty((-(-n // _MARGIN_THREADS),), **f32)
    loss = torch.empty((), **f32)
    dev, stream = build.stream_and_device(X)
    err = build.library().margin_obj(
        X.data_ptr(), int(X.dtype == torch.bfloat16), w.data_ptr(),
        y.data_ptr(), b.data_ptr(), n, vm, rows_per_split, splits,
        part.data_ptr(), u.data_ptr(), xi.data_ptr(), loss_part.data_ptr(),
        loss.data_ptr(), dev, stream)
    build.check(err, "margin_obj")
    LAUNCHES["margin_obj"] += 1
    return u, xi, loss


def hinge_grad_plain(X, y, xi, valid_m: Optional[int] = None):
    """Plain PyTorch version of :func:`hinge_grad_op` (fp32 accumulation)."""
    vm = _live_rows(X, valid_m)
    g = torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
    g[:vm] = -torch.mv(X[:vm].float(), y * xi)
    return g


def hinge_grad_op(X, y, xi, valid_m: Optional[int] = None):
    """``g = -X (y * xi)`` over X's first ``valid_m`` rows, zeros past them.

    ``X`` (m, n) fp32/bf16; ``y``, ``xi`` (n,) fp32. Returns (m,) fp32.
    """
    if not build.on_card(X):
        return hinge_grad_plain(X, y, xi, valid_m)
    build.check_matrix(X)
    m, n = X.shape
    vm = _live_rows(X, valid_m)
    build.check_vector(y, n, X, "y")
    build.check_vector(xi, n, X, "xi")
    g = torch.empty((m,), dtype=torch.float32, device=X.device)
    dev, stream = build.stream_and_device(X)
    err = build.library().hinge_grad(
        X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(),
        xi.data_ptr(), m, n, vm, g.data_ptr(), dev, stream)
    build.check(err, "hinge_grad")
    LAUNCHES["hinge_grad"] += 1
    return g
