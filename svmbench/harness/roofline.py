"""The chip's peaks and the work a path needs, counted from its shapes.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3 and
67 TFLOP/s in float32 outside the tensor cores, at a 700 W limit.

A path's useful work is counted the same whatever implements it. Per step
``k`` of a path over a training fold of ``m`` features and ``n`` samples:

* the solve: ``iters_k`` FISTA iterations, each two sweeps over the reduced
  problem (the margin ``X^T w`` and the gradient ``X (y xi)``), so
  ``2 * iters_k * kept_k * kept_samples_k`` elements of X read, two flops
  each (a multiply and an add);
* the screen: one sweep over the fold (``m * n`` elements) at every step
  after the first, which screens from the anchor before it.

Each element read counts once per sweep whatever the implementation reads
again, and padding, the Lipschitz estimate, the certificate and the
verification's re-solves count nothing, so the counts never exceed what
any correct implementation reads.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_seconds(bytes_: float, flops: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def step_elements(rec: dict, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``(kept features, kept samples)`` per step; a step that reports no
    sample count (an engine that never screens samples) keeps all ``n``."""
    kept = np.asarray(rec["kept"], np.float64)
    ks = np.asarray(rec["kept_samples"], np.float64)
    return kept, np.where(ks > 0, ks, float(n))


def sweep_elements(rec: dict, n: int) -> float:
    """Elements of X the solver's two sweeps read over the path."""
    kept, ks = step_elements(rec, n)
    return float(np.sum(2.0 * np.asarray(rec["iters"], np.float64) * kept * ks))


def screen_elements(rec: dict, m: int, n: int) -> float:
    """Elements of X the screens read: one sweep a step after the first."""
    return float(max(len(rec["kept"]) - 1, 0)) * m * n


def sweep_bound_s(rec: dict, n: int, elem_bytes: int) -> float:
    e = sweep_elements(rec, n)
    return bound_seconds(e * elem_bytes, 2.0 * e)


def path_bound_s(rec: dict, m: int, n: int, elem_bytes: int) -> float:
    e = sweep_elements(rec, n) + screen_elements(rec, m, n)
    return bound_seconds(e * elem_bytes, 2.0 * e)


def kept_share(rec: dict, m: int, n: int) -> float:
    """The reduced problems' elements over the whole path's, ``T m n``."""
    kept, ks = step_elements(rec, n)
    return float(np.sum(kept * ks)) / (len(kept) * float(m) * n)
