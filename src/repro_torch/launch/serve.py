"""Batched serving loop: continuous-batching decode driver.

A minimal production-shaped server, the reference's (``repro.launch.serve``):
a request queue feeds fixed slots of a decode batch; finished/empty slots
are refilled between steps (continuous batching), and each step is one
``decode_step`` over the whole batch, every slot decoded whether live or
not. Prefill for an incoming request runs at batch 1 with the server's
``max_seq``, and its cache rows are spliced into the live batch cache (slot
insertion); its argmax is the request's first token. Tokens are the argmax
of the logits in the compute dtype (the first maximum on a tie).

The server keeps one copy of the weights cast to the compute dtype
(``transformer.serving_params``): the values the reference's per-product
casts give, read once a step.

It serves every family the reference's server serves: dense, moe (MLA and
GQA attention), ssm, hybrid, and vlm on tokens alone (the requests carry no
prefix embeddings). An SSM's prompt must be shorter than ``ssm_chunk`` or a
multiple of it, as the reference's prefill asserts. It refuses enc-dec
models with ``ValueError``: a request carries no encoder frames, and the
reference's server fails on one at its first prefill (``KeyError``).

CPU smoke: PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models import transformer as tr
from ..models.cache import init_cache
from .steps import make_prefill, make_serve_step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


class BatchedServer:
    def __init__(self, cfg, params, batch_slots: int = 4, max_seq: int = 256,
                 device="cuda"):
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the server does not serve the enc-dec family "
                             "(a request carries no encoder frames)")
        self.device = resolve_device(device)
        on = params["final_norm"]["scale"].device
        if on.type != self.device.type:
            raise ValueError(f"the parameters are on {on}, the server on {self.device}")
        self.cfg = cfg
        self.params = tr.serving_params(params, cfg)
        self.slots = batch_slots
        self.max_seq = max_seq
        self.cache = init_cache(cfg, batch=batch_slots, max_seq=max_seq, device=self.device)
        self.positions = np.zeros((batch_slots,), np.int32)
        self.last_tok = np.zeros((batch_slots,), np.int32)
        self.active: list[Optional[Request]] = [None] * batch_slots
        self.step_fn = make_serve_step(cfg)
        self.prefill_fn = make_prefill(cfg, max_seq)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int64).to(self.device)

    def _insert(self, slot: int, req: Request):
        logits, cache1 = self.prefill_fn(self.params, {"tokens": self._tensor(req.prompt[None, :])})
        # splice the single-row cache into slot `slot`
        for seg, seg1 in zip(self.cache["segments"], cache1["segments"]):
            for name, slot_cache in seg.items():
                for key, full in slot_cache.items():
                    full[:, slot:slot + 1] = seg1[name][key].to(full.dtype)
        tok = int(torch.argmax(logits[0]))
        req.out.append(tok)
        self.active[slot] = req
        self.positions[slot] = len(req.prompt)
        self.last_tok[slot] = tok

    def step(self):
        toks = self._tensor(self.last_tok[:, None])
        pos = self._tensor(self.positions)
        logits, self.cache = self.step_fn(self.params, self.cache, toks, pos)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        for s, req in enumerate(self.active):
            if req is None or req.done:
                continue
            req.out.append(int(nxt[s]))
            self.positions[s] += 1
            self.last_tok[s] = nxt[s]
            if len(req.out) >= req.max_new or self.positions[s] >= self.max_seq - 1:
                req.done = True
                self.active[s] = None

    def serve(self, requests: list[Request], log=print):
        queue = list(requests)
        t0 = time.perf_counter()
        n_steps = 0
        while queue or any(r is not None for r in self.active):
            for s in range(self.slots):
                if self.active[s] is None and queue:
                    self._insert(s, queue.pop(0))
            self.step()
            n_steps += 1
        dt = time.perf_counter() - t0
        toks = sum(len(r.out) for r in requests)
        log(f"[serve] {len(requests)} requests, {toks} tokens, "
            f"{n_steps} steps, {toks / dt:.1f} tok/s")
        return requests


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="an architecture of repro_torch.configs of the dense, moe, "
                         "ssm, hybrid or vlm family (enc-dec whisper-base is refused)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-smoke) config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    params = tr.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    server = BatchedServer(cfg, params, batch_slots=args.slots, max_seq=128, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, rng.integers(4, 24)).astype(np.int32),
                    max_new=8)
            for i in range(args.requests)]
    server.serve(reqs)
    for r in reqs:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
