"""Synthetic sparse-SVM data and the libsvm reader (numpy only; same
arrays as ``repro.data``)."""

from .svm import (  # noqa: F401
    CsrData,
    SvmDataset,
    csr_from_dense,
    iter_libsvm,
    load_libsvm,
    make_sparse_classification,
)
