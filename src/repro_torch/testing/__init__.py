"""Test-support utilities (fault injection; port of the reference
``testing``)."""

from .faults import (
    corrupt_store_bytes,
    dead_reads,
    flaky_reads,
    poison_path_step,
    poison_stream_iterate,
    truncate_store_file,
)

__all__ = [
    "corrupt_store_bytes",
    "dead_reads",
    "flaky_reads",
    "poison_path_step",
    "poison_stream_iterate",
    "truncate_store_file",
]
