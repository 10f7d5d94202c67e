"""The serve steps shared by the serving loop.

``make_serve_step(cfg)`` returns the single-token decode step used by the
serving loop, ``make_prefill(cfg, max_seq)`` the prompt pass, as the
reference's (``repro.launch.steps``). ``TrainState`` and
``make_train_step`` wait for ROADMAP item 16c.
"""

from __future__ import annotations

from typing import Optional

from ..models import transformer as tr


def make_serve_step(cfg):
    """decode: (params, cache, tokens, positions) -> (logits, cache)."""
    def step(params, cache, tokens, positions):
        return tr.decode_step(params, cfg, tokens, positions, cache)
    return step


def make_prefill(cfg, max_seq: Optional[int] = None):
    def run(params, batch):
        return tr.prefill(params, cfg, batch, max_seq=max_seq)
    return run
