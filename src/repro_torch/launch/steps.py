"""The train and serve steps shared by the trainer and the serving loop,
as the reference's (``repro.launch.steps``).

``make_train_step(cfg)`` returns ``step(state, batch) -> (state, metrics)``:
gradient accumulation over microbatches, the cosine schedule, AdamW, and
NaN/Inf step rejection. ``make_serve_step(cfg)`` returns the single-token
decode step of the serving loop, ``make_prefill(cfg, max_seq)`` the prompt
pass.

The step updates ``state`` in place (the parameters and moments leaf by
leaf, see ``optim.adamw``) and returns it. The gradients are taken with
``torch.autograd.grad`` on aliases of the parameters (``detach()`` views
that require grad), so the state's own tensors never require grad. The
loss and the gradient norm are fetched to the host once a step (with the
rate and the loss's parts); a step whose loss or gradient norm is not
finite is skipped before the update, so parameters, moments and the
optimizer's step stay exactly as they were (the reference computes the
update and selects the old state back). The step's two halves are
``torch.profiler`` regions, ``train_step.grads`` and ``train_step.update``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..device import resolve_device
from ..models import transformer as tr
from ..optim import adamw_update, cosine_schedule, global_norm
from ..optim.adamw import AdamWState, adamw_init
from ..tree import leaves, tree_map


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState


def init_train_state(cfg, generator: torch.Generator, device="cuda",
                     moment_dtype=torch.float32) -> TrainState:
    """Parameters drawn from ``generator`` (``models.transformer.init_params``)
    and zero AdamW moments in ``moment_dtype``, on ``device``."""
    params = tr.init_params(cfg, generator, resolve_device(device))
    return TrainState(params=params, opt=adamw_init(params, moment_dtype))


def _value_and_grads(cfg, params, batch):
    """``(loss, metrics, grads)``: the loss and its parts detached, the
    gradients a list in the order of ``tree.leaves(params)``."""
    alias = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = tr.loss_fn(alias, cfg, batch)
    grads = torch.autograd.grad(loss, leaves(alias))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)


class TrainStep(NamedTuple):
    """``step(state, batch) -> (state, metrics)`` (see
    :func:`make_train_step`), and its halves around its one host fetch."""
    #: ``(state, batch) -> (loss, metrics, grads, lr, grad_norm)``, device
    #: values only: the gradients, the scheduled rate and their norm
    device_step: Callable
    #: ``(state, grads, lr, grad_norm) -> state``: the AdamW update
    update: Callable

    def __call__(self, state: TrainState, batch):
        loss_val, metrics, grads, lr, gn = self.device_step(state, batch)
        # one host fetch a step: what the rejection decides on, and the metrics
        names = ("loss", "grad_norm", "lr", *metrics)
        values = torch.stack([loss_val.float(), gn, lr, *metrics.values()]).tolist()
        out = dict(zip(names, values))
        bad = not (math.isfinite(out["loss"]) and math.isfinite(out["grad_norm"]))
        if not bad:
            state = self.update(state, grads, lr, gn)
        out["skipped"] = int(bad)
        return state, out


def make_train_step(
    cfg,
    base_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    microbatches: int = 1,
    weight_decay: float = 0.1,
) -> TrainStep:
    """``step(state, batch) -> (state, metrics)``. ``batch``: ``tokens`` and
    ``targets`` (B, S) integer tensors on the state's device (and an enc-dec
    model's ``enc_embeds`` or a VLM's ``prefix_embeds``). ``metrics``: host
    floats ``loss``, ``lr``, ``grad_norm``, ``ce`` and ``aux``, and the int
    ``skipped`` (1 for a rejected step). With ``microbatches > 1`` the
    batch's rows are split into that many microbatches, their gradients
    summed in float32 and averaged, the loss averaged, and ``ce``/``aux``
    are not reported (the reference's ``metrics = {}``); a batch whose rows
    do not split evenly raises ``ValueError``."""

    def device_step(state: TrainState, batch):
        with torch.profiler.record_function("train_step.grads"):
            loss_val, metrics, grads = grads_of(state.params, batch)
        lr = cosine_schedule(state.opt.step, base_lr, warmup_steps, total_steps)
        return loss_val, metrics, grads, lr, global_norm(grads)

    def update(state: TrainState, grads, lr, gn) -> TrainState:
        with torch.profiler.record_function("train_step.update"):
            _, opt, _ = adamw_update(grads, state.opt, state.params, lr,
                                     weight_decay=weight_decay, gnorm=gn)
        return TrainState(state.params, opt)

    def grads_of(params, batch):
        if microbatches == 1:
            return _value_and_grads(cfg, params, batch)
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"a batch of {B} rows does not split into "
                             f"microbatches={microbatches} equal microbatches")
        mb = B // microbatches
        grads = lsum = None
        for i in range(microbatches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _, g = _value_and_grads(cfg, params, part)
            if grads is None:
                grads = [x.float() if x.dtype != torch.float32 else x for x in g]
                lsum = loss
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x)
                lsum = lsum + loss
        for acc in grads:
            acc.div_(microbatches)
        return lsum / microbatches, {}, grads

    return TrainStep(device_step, update)


def make_serve_step(cfg):
    """decode: (params, cache, tokens, positions) -> (logits, cache)."""
    def step(params, cache, tokens, positions):
        return tr.decode_step(params, cfg, tokens, positions, cache)
    return step


def make_prefill(cfg, max_seq: Optional[int] = None):
    def run(params, batch):
        return tr.prefill(params, cfg, batch, max_seq=max_seq)
    return run
