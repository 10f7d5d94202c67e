"""Synthetic sparse-SVM data, the libsvm reader and the synthetic token
pipeline (numpy only; same arrays as ``repro.data``)."""

from .svm import (  # noqa: F401
    CsrData,
    SvmDataset,
    csr_from_dense,
    iter_libsvm,
    load_libsvm,
    make_sparse_classification,
)
from .tokens import ArraySpec, TokenPipeline, synthetic_batch_specs  # noqa: F401
