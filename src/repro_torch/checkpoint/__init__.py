"""Checkpoints of path state (port of the reference ``checkpoint``)."""

from .manager import CheckpointManager, load_pytree, save_pytree  # noqa: F401
