"""Synthetic sparse-SVM data (numpy only; same arrays as ``repro.data``)."""

from .svm import CsrData, SvmDataset, csr_from_dense, make_sparse_classification  # noqa: F401
