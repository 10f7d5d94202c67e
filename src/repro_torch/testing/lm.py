"""Recording what a ``BatchedServer`` computes, for checks of its serving
loop (the port's tests and ``chip_smoke.py``): its steps' logits, and the
routing of its MoE layers."""

from __future__ import annotations

import torch

from ..tree import is_distributed


def _whole(t):
    """``t``, or a DTensor's gathered whole."""
    return t.full_tensor() if is_distributed(t) else t


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


class RouteRecorder:
    """Records the routing of every MoE call made while it is active (a
    context manager that wraps ``models.moe.route``): per call the group
    size, the tokens, the (token, choice) pairs kept and dropped, and the
    experts that hold a kept one (those whose weights the call reads);
    with ``keep``, also each token's experts (``top_i``, (BN, g, k)) and
    router logits (``logits``, (BN, g, E) float32), on the host. A call on
    a mesh (DTensor operands) is recorded from its gathered whole."""

    def __init__(self, keep: bool = False):
        self.keep, self.calls = keep, []

    def __enter__(self):
        from ..models import moe

        self._moe, self._route = moe, moe.route

        def route(params, xg, cfg, act_dtype):
            r = self._route(params, xg, cfg, act_dtype)
            fits, top_i = _whole(r.fits), _whole(r.top_i)
            call = {"group": xg.shape[1], "tokens": xg.shape[0] * xg.shape[1],
                    "kept": int(fits.sum()), "dropped": int((~fits).sum()),
                    "experts": int(torch.unique(top_i[fits]).numel())}
            if self.keep:
                call["top_i"] = top_i.cpu()
                call["logits"] = _whole(xg @ params["router"].to(act_dtype)).float().cpu()
            self.calls.append(call)
            return r
        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route
        return False
