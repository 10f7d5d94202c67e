"""Synthetic datasets for the sparse-SVM workload (pure numpy).

A copy of ``make_sparse_classification``, ``SvmDataset``, ``CsrData`` and
``csr_from_dense`` from the reference package's ``data/svm.py``: the same
seed gives bit-identical arrays. Kept as a copy because the port imports
nothing of the reference package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

__all__ = ["SvmDataset", "CsrData", "make_sparse_classification",
           "csr_from_dense"]

class CsrData(NamedTuple):
    """CSR triple over *feature rows* (the paper's (m, n) layout)."""

    data: np.ndarray     # (nnz,)
    indices: np.ndarray  # (nnz,) int32 sample (column) indices
    indptr: np.ndarray   # (m + 1,) int64
    shape: tuple         # (m, n)

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def density(self) -> float:
        m, n = self.shape
        return self.nnz / max(m * n, 1)

    def to_dense(self, dtype=None) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n), dtype=dtype or self.data.dtype)
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        out[rows, self.indices] = self.data
        return out


class SvmDataset(NamedTuple):
    X: np.ndarray       # (m, n) features x samples (paper layout)
    y: np.ndarray       # (n,) in {-1, +1}
    w_true: np.ndarray  # (m,) ground-truth sparse direction
    #: true CSR view of X (same values, same dtype) for sparse designs;
    #: ``None`` when the matrix is dense (``density == 1``)
    csr: Optional[CsrData] = None


def csr_from_dense(X: np.ndarray) -> CsrData:
    """Exact CSR triple of a host matrix (row-major, numpy only)."""
    X = np.asarray(X)
    nz = X != 0
    indptr = np.concatenate([[0], np.cumsum(nz.sum(axis=1))]).astype(np.int64)
    return CsrData(
        data=X[nz],
        indices=np.nonzero(nz)[1].astype(np.int32),
        indptr=indptr,
        shape=tuple(X.shape),
    )


def make_sparse_classification(
    m: int = 512,
    n: int = 256,
    k_active: int = 16,
    noise: float = 0.25,
    density: float = 1.0,
    seed: int = 0,
    dtype=np.float32,
    correlated: float = 0.0,
) -> SvmDataset:
    """Two-class data: ``y = sign(w_true^T x + eps)`` with k-sparse w_true.

    ``density < 1`` zeroes random entries of X (text-like sparsity) and the
    returned dataset carries a true CSR triple (``.csr``) of the final
    matrix. To keep that sparsity *real*, sparse designs are standardized by
    feature scale only (no mean-centering — centering would densify every
    row; this matches how sparse text features are used in practice).
    Dense designs keep the paper's full standardization. ``correlated > 0``
    mixes features with an AR(1)-style factor to create correlated
    (harder-to-screen) designs.
    """
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n))
    if correlated > 0.0:
        common = rng.standard_normal((1, n))
        X = np.sqrt(1 - correlated) * X + np.sqrt(correlated) * common
    sparse = density < 1.0
    if sparse:
        X *= rng.random((m, n)) < density

    w_true = np.zeros((m,))
    idx = rng.choice(m, size=k_active, replace=False)
    w_true[idx] = rng.standard_normal(k_active) * 2.0

    scores = w_true @ X + noise * rng.standard_normal(n)
    y = np.where(scores >= np.median(scores), 1.0, -1.0)
    # feature standardization (paper experiments standardize); scale-only
    # for sparse designs so zeros stay zeros
    if sparse:
        X = X / (X.std(axis=1, keepdims=True) + 1e-12)
    else:
        X = (X - X.mean(axis=1, keepdims=True)) / (X.std(axis=1, keepdims=True) + 1e-12)
    X = X.astype(dtype)
    csr = csr_from_dense(X) if sparse else None
    return SvmDataset(X, y.astype(dtype), w_true.astype(dtype), csr)

