"""Test-support utilities (fault injection; port of the reference
``testing``; ``lm.StepRecorder`` for the LM server's checks)."""

from .faults import (
    ServerKilled,
    corrupt_store_bytes,
    dead_reads,
    flaky_reads,
    kill_server_after,
    poison_path_step,
    poison_server_slot,
    poison_stream_iterate,
    truncate_store_file,
)

__all__ = [
    "ServerKilled",
    "corrupt_store_bytes",
    "dead_reads",
    "flaky_reads",
    "kill_server_after",
    "poison_path_step",
    "poison_server_slot",
    "poison_stream_iterate",
    "truncate_store_file",
]
