"""PyTorch/CUDA port of the sparse-SVM screening system (``repro``).

``repro`` (JAX + Pallas) is the reference; this package runs the paper's
screened regularization path on an NVIDIA H100 with hand-written CUDA
kernels for the O(mn) sweeps, and on the CPU with their plain PyTorch
versions. It imports ``torch`` and never ``jax`` or ``repro``.

Layout mirrors ``repro``: ``core/`` (dual, screening, solver, rules, path),
``kernels/`` (CUDA sources, build, wrappers), ``data/`` and ``launch/``.
X is ``(m, n)``, features x samples.

Entry points run on the card by default (``device="cuda"``) and raise when
no GPU is present; pass ``device="cpu"`` for the plain versions.
"""

import importlib

from .device import resolve_device  # noqa: F401


def __getattr__(name):
    """The entry points of :mod:`repro_torch.core` (``svm_path``,
    ``PathDriver``, ``fista_solve_dynamic``, ...), imported on first access."""
    core = importlib.import_module(".core", __name__)
    if name in core.__all__:
        return getattr(core, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
