"""Deterministic synthetic token pipeline for LM training (numpy only).

The reference's (``repro.data.tokens``), array for array: a pure function
of ``(seed, step)``, so a restarted job replays the exact same batches and
no pipeline state needs checkpointing beyond the integer step.

Each batch is packed next-token prediction over a Zipfian unigram
distribution mixed with a running-sum shift, so that p(next | current) is
learnable without any external corpus.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple

import numpy as np


class ArraySpec(NamedTuple):
    """The shape and dtype of one array of a batch."""
    shape: tuple
    dtype: np.dtype


def synthetic_batch_specs(batch: int, seq: int, vocab: int) -> dict[str, ArraySpec]:
    """The arrays :meth:`TokenPipeline.batch_at` returns, without making them."""
    spec = ArraySpec((batch, seq), np.dtype(np.int32))
    return {"tokens": spec, "targets": spec}


@dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    batch_size: int           # per-host batch
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Batch for a given global step: stateless, replayable; int32
        ``tokens`` and ``targets`` of shape (batch_size, seq_len)."""
        rng = np.random.default_rng((self.seed, step))
        v = self.vocab_size
        raw = rng.zipf(self.zipf_a, size=(self.batch_size, self.seq_len + 1))
        base = (raw - 1) % v
        shift = np.cumsum(base, axis=1) % v
        toks = np.where(rng.random(base.shape) < 0.5, base, shift).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
