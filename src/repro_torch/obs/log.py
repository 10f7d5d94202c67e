"""Structured logging setup for the repro_torch package (a copy of the
reference ``obs/log.py``).

Module-level loggers everywhere (``log = get_logger(__name__)``), one
idempotent handler configured on the ``repro_torch`` root by :func:`setup` —
called by the launchers' ``main()``, never at import time, so library
users keep full control of logging config. The level is env-tunable via
``REPRO_LOG_LEVEL`` (default ``INFO``), matching the repo's other env
toggles (``REPRO_SOLVER_GUARDS``, ``REPRO_TRACE``, ...).

Launch-loop call sites keep their ``log=`` parameter for injection
(benchmarks pass ``print``; tests capture); the default is now the
module logger's ``info`` instead of a bare ``print``.
"""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["get_logger", "setup"]

_CONFIGURED = False


def get_logger(name: str = "") -> logging.Logger:
    """A logger under the ``repro_torch`` hierarchy (dotted names pass through)."""
    if not name:
        return logging.getLogger("repro_torch")
    if name == "repro_torch" or name.startswith("repro_torch."):
        return logging.getLogger(name)
    return logging.getLogger(f"repro_torch.{name}")


def setup(level=None, stream=None, force: bool = False) -> logging.Logger:
    """Attach one stream handler to the ``repro_torch`` root logger.

    ``level``: explicit level (name or number); defaults to the
    ``REPRO_LOG_LEVEL`` environment variable, then ``INFO``. Idempotent —
    repeated calls only adjust the level unless ``force=True`` replaces
    the handler (tests redirecting ``stream``).
    """
    global _CONFIGURED
    root = logging.getLogger("repro_torch")
    if level is None:
        level = os.environ.get("REPRO_LOG_LEVEL", "INFO")
    if isinstance(level, str):
        level = level.upper()
    root.setLevel(level)
    if _CONFIGURED and not force:
        return root
    if force:
        for h in list(root.handlers):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S"))
    root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True
    return root
