"""The feature-axis VI screen: CUDA kernel and plain version.

One read of X gives every feature row's four reductions
``[f.(y theta1), f.y, f.1, ||f||^2]``; the closed-form bound of
``core/screening.py`` (:func:`~repro_torch.core.screening._t_max`) is then
applied in registers and only the ``(m,)`` bounds are written. The
feature-independent scalars travel as one packed fp32 vector
(:func:`pack_shared`), in the reference's ``pack_shared`` order, and stay
on the device.

For a CUDA ``X`` :func:`screen_bounds_from_shared` launches
``csrc/screen.cu`` and counts the launch in :data:`LAUNCHES`; for a CPU
``X`` it runs :func:`screen_bounds_plain`. The kernel replaces the
reference's Pallas ``_feature_kernel`` (``repro/kernels/screen.py``).
"""

from __future__ import annotations

import torch

from ..core.screening import (
    ScreenShared,
    feature_reductions,
    screen_bounds_from_reductions,
    shared_scalars,
)
from . import build

#: launches of the kernel in this process (reset by ``ops.reset_launch_counts``)
LAUNCHES = {"screen_bounds": 0}

NUM_SCALARS = 12  # packed scalars, padded as in the reference


def pack_shared(sh: ScreenShared) -> torch.Tensor:
    """Pack the scalars the finalizer reads into a flat (12,) fp32 vector:
    ``inv_lam1, inv_lam2, yc, ysq, r_h_sq, g0, qa_sq, a_norm, a_dot_y,
    halfspace_valid``, zero-padded. Stays on the scalars' device."""
    vals = [sh.inv_lam1, sh.inv_lam2, sh.yc, sh.ysq, sh.r_h_sq, sh.g0,
            sh.qa_sq, sh.a_norm, sh.a_dot_y, sh.halfspace_valid]
    v = torch.stack([torch.as_tensor(x).to(torch.float32) for x in vals])
    return torch.nn.functional.pad(v, (0, NUM_SCALARS - v.shape[0]))


def screen_bounds_plain(X, y, theta1, sh: ScreenShared) -> torch.Tensor:
    """Plain PyTorch version of :func:`screen_bounds_from_shared`."""
    red = feature_reductions(X.float(), y.float(), theta1.float())
    return screen_bounds_from_reductions(red, sh)


def screen_bounds_from_shared(X, y, theta1, sh: ScreenShared) -> torch.Tensor:
    """Per-feature VI bounds ``(m,)`` fp32 from one sweep of X, given the
    region's shared scalars ``sh`` (``core/screening.shared_scalars``)."""
    if not build.on_card(X):
        return screen_bounds_plain(X, y, theta1, sh)
    build.check_matrix(X)
    m, n = X.shape
    build.check_vector(y, n, X, "y")
    build.check_vector(theta1, n, X, "theta1")
    scalars = pack_shared(sh).to(X.device)
    bounds = torch.empty((m,), dtype=torch.float32, device=X.device)
    dev, stream = build.stream_and_device(X)
    err = build.library().screen_bounds_features(
        X.data_ptr(), int(X.dtype == torch.bfloat16), y.data_ptr(),
        theta1.data_ptr(), scalars.data_ptr(), m, n, bounds.data_ptr(), dev,
        stream)
    build.check(err, "screen_bounds")
    LAUNCHES["screen_bounds"] += 1
    return bounds


def screen_bounds_op(X, y, lam1, lam2, theta1, delta=0.0) -> torch.Tensor:
    """Fused screening bounds for all m features, targeting ``lam2`` from the
    anchor ``theta1`` at ``lam1`` with inexactness radius ``delta`` (which
    enters only through the shared scalars)."""
    sh = shared_scalars(y.float(), lam1, lam2, theta1.float(), delta=delta)
    return screen_bounds_from_shared(X, y, theta1, sh)
