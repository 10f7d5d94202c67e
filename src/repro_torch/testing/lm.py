"""Recording what a ``BatchedServer`` computes, for checks of its serving
loop (the port's tests and ``chip_smoke.py``)."""

from __future__ import annotations


class StepRecorder:
    """Wraps a ``BatchedServer``'s decode step and prefill: each step's
    logits and, per slot, ``(rid, tokens the request had then)`` of the
    request it served (``None`` for an idle slot); each prefill's logits."""

    def __init__(self, server):
        self.server, self.step_fn, self.prefill_fn = server, server.step_fn, server.prefill_fn
        self.steps, self.prefills = [], []
        server.step_fn, server.prefill_fn = self.step, self.prefill

    def step(self, params, cache, tokens, positions):
        logits, cache = self.step_fn(params, cache, tokens, positions)
        live = [(r.rid, len(r.out)) if r is not None else None for r in self.server.active]
        self.steps.append((logits.clone(), live))
        return logits, cache

    def prefill(self, params, batch):
        logits, cache = self.prefill_fn(params, batch)
        self.prefills.append(logits.clone())
        return logits, cache

    def decodes(self, rid) -> list:
        """``(k, logits)`` of each decode step of request ``rid``, ``k`` the
        tokens it had generated before that step."""
        return [(live[s][1], logits[s]) for logits, live in self.steps
                for s in range(len(live)) if live[s] is not None and live[s][0] == rid]
