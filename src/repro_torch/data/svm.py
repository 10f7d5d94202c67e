"""Synthetic and on-disk datasets for the sparse-SVM workload (pure numpy).

A copy of ``make_sparse_classification``, ``SvmDataset``, ``CsrData``,
``csr_from_dense`` and the libsvm text reader (``iter_libsvm``,
``load_libsvm``) from the reference package's ``data/svm.py``: the same
seed gives bit-identical arrays, the same file the same arrays and the same
error messages. Kept as a copy because the port imports nothing of the
reference package.
"""

from __future__ import annotations

import gzip
from typing import Iterator, NamedTuple, Optional

import numpy as np

__all__ = ["SvmDataset", "CsrData", "make_sparse_classification",
           "csr_from_dense", "load_libsvm", "iter_libsvm"]

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


def _open_maybe_gzip(path):
    """Text handle for a libsvm file, gunzipped when its first two bytes
    are the gzip magic ``1f 8b`` (by content, not by extension)."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def iter_libsvm(path, zero_based: bool = False) -> Iterator[tuple]:
    """Stream ``(label, feature_indices, values)`` per sample from a libsvm
    text file (plain or gzip), in O(one line) of memory.

    The one parser of :func:`load_libsvm` and of
    ``sparse.FeatureChunked.from_libsvm_cached``. Comment lines and trailing
    ``# comments`` are stripped, blank lines skipped; indices are 1-based
    unless ``zero_based``. A malformed line raises ``ValueError`` naming the
    file, the 1-based line number and the offending token.
    """
    with _open_maybe_gzip(path) as fh:
        for lineno, raw in enumerate(fh, start=1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            try:
                label = float(parts[0])
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: malformed label {parts[0]!r} "
                    f"(expected a number)") from None
            idx, vals = [], []
            for tok in parts[1:]:
                k, sep, v = tok.partition(":")
                if not sep:
                    raise ValueError(
                        f"{path}:{lineno}: malformed feature token {tok!r} "
                        f"(expected <index>:<value>)")
                try:
                    j = int(k) - (0 if zero_based else 1)
                    val = float(v)
                except ValueError:
                    raise ValueError(
                        f"{path}:{lineno}: malformed feature token {tok!r} "
                        f"(index must be an integer, value a number)"
                    ) from None
                if j < 0:
                    raise ValueError(
                        f"{path}:{lineno}: feature index {k} is not "
                        f"{'0' if zero_based else '1'}-based"
                    )
                idx.append(j)
                vals.append(val)
            yield label, idx, vals


def load_libsvm(path, n_features: Optional[int] = None, dtype=np.float32,
                zero_based: bool = False) -> SvmDataset:
    """Libsvm/svmlight text into the paper's (m, n) layout.

    Each line is ``<label> <index>:<value> ...``. Labels map to {-1, +1} by
    sign (0/1 labels to -1/+1). Returns an :class:`SvmDataset` whose ``X``
    is the dense ``(n_features, n_samples)`` host matrix in ``dtype``, with
    ``.csr`` its exact CSR triple over feature rows (for
    ``sparse.FeatureChunked.from_csr``) and ``w_true`` zeros. For data that
    must stay out of host RAM use ``FeatureChunked.from_libsvm_cached``.
    """
    feats, samples, vals, labels = [], [], [], []
    for label, idx, vv in iter_libsvm(path, zero_based=zero_based):
        labels.append(label)
        i = len(labels) - 1
        feats.extend(idx)
        samples.extend([i] * len(idx))
        vals.extend(vv)
    n = len(labels)
    if n == 0:
        raise ValueError(f"no samples in {path}")
    m = int(n_features) if n_features else (max(feats) + 1 if feats else 0)
    X = np.zeros((m, n), dtype=dtype)
    if feats:
        f = np.asarray(feats)
        if f.max() >= m:
            raise ValueError(f"feature index {f.max()} >= n_features={m}")
        X[f, np.asarray(samples)] = np.asarray(vals, dtype=dtype)
    y = np.where(np.asarray(labels) > 0, 1.0, -1.0).astype(dtype)
    return SvmDataset(X, y, np.zeros((m,), dtype), csr_from_dense(X))
