"""AdamW with global-norm clipping, decoupled weight decay, and a dtype
policy for the moments (float32 default; bf16 for memory-bound giants), as
the reference's (``repro.optim.adamw``).

Parameters, moments and gradients are trees (nested dicts and lists) of
tensors with one structure; leaves are visited in the order of
:func:`repro_torch.tree.leaves`. The update is the reference's float32 arithmetic in its
order: the gradients clipped in their own dtype, the bias corrections
``c1``, ``c2`` from the step, ``(m/c1) / (sqrt(v/c2) + eps) + wd*p`` and
``p - lr*update``, each result cast back to its leaf's dtype.

Where a leaf and its moments are float32 the update runs in place, leaf by
leaf: the moments with ``mul_``/``add_``, the gradient (which the update
consumes) and one scratch tensor the size of the largest leaf holding the
terms, every operation the one of the functional form (the same float32
values, bit for bit; ``tests/test_torch_optim.py``). At qwen2.5-3b's width
the functional form would hold 4-5 temporaries of a 3.25 GB stacked leaf;
this one holds one. Other dtypes, and DTensor leaves (the dry run's), take
the functional form leaf by leaf.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..tree import is_distributed, leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-dim
    mu: dict
    nu: dict


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    """Zero moments in ``moment_dtype``, the step 0, on the parameters' device."""
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=first.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, float32."""
    total = 0
    for g in leaves(grads):
        if is_distributed(g):
            # a sharded DTensor flattened is a strided shard, whose offsets
            # DTensor builds as a tensor of the leaf's global size: its
            # square summed in place of the flat dot
            total = total + torch.sum(torch.square(g.float()))
            continue
        v = g.reshape(-1) if g.dtype == torch.float32 else g.reshape(-1).float()
        total = total + torch.dot(v, v)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, gnorm: Optional[torch.Tensor] = None):
    """Scales ``grads`` in place by ``min(1, max_norm / max(gn, 1e-12))``, in
    each leaf's dtype. Returns ``(grads, gn)``; ``gnorm`` is
    :func:`global_norm` of ``grads`` when the caller has it."""
    gn = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, gn


def _update_inplace(g, m, v, p, tmp, c1, c2, lr, b1, b2, eps, wd):
    """One float32 leaf: the functional form's operations, in its order,
    on ``m``, ``v``, ``p`` in place; ``g`` and ``tmp`` are scratch."""
    m.mul_(b1)
    torch.mul(g, 1 - b1, out=tmp)
    m.add_(tmp)                                   # m_new = b1*m + (1-b1)*g
    v.mul_(b2)
    torch.mul(g, 1 - b2, out=tmp)
    tmp.mul_(g)
    v.add_(tmp)                                   # v_new = b2*v + (1-b2)*g*g
    torch.div(v, c2, out=tmp)
    tmp.sqrt_()
    tmp.add_(eps)                                 # sqrt(v_new/c2) + eps
    torch.div(m, c1, out=g)
    g.div_(tmp)                                   # (m_new/c1) / (...)
    torch.mul(p, wd, out=tmp)
    g.add_(tmp)                                   # update + wd*p
    torch.mul(g, lr, out=tmp)
    p.sub_(tmp)                                   # p - lr*update


def _update_functional(g, m, v, p, c1, c2, lr, b1, b2, eps, wd):
    g32 = g.float()
    m_new = b1 * m.float() + (1 - b1) * g32
    v_new = b2 * v.float() + (1 - b2) * g32 * g32
    update = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    update = update + wd * p.float()
    p_new = p.float() - lr * update
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 gnorm: Optional[torch.Tensor] = None):
    """One AdamW step. Updates ``params`` and the moments in place and
    consumes ``grads`` (their tensors are scratch afterwards). ``lr`` is a
    float or a 0-dim tensor (the schedule's); ``gnorm`` is
    :func:`global_norm` of ``grads`` when the caller has it. Returns
    ``(params, new_state, {"grad_norm": gn})``, the state's step advanced."""
    _, gnorm = clip_by_global_norm(grads, max_grad_norm, gnorm)
    step = state.step + 1
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    flat = list(zip(leaves(grads), leaves(state.mu), leaves(state.nu), leaves(params),
                    strict=True))
    # DTensor leaves take the functional form: the scratch is a plain tensor
    dist = bool(flat) and is_distributed(flat[0][0])
    inplace = [not dist and all(t.dtype == torch.float32 for t in leaf) for leaf in flat]
    size = max((g.numel() for (g, _, _, _), ok in zip(flat, inplace) if ok), default=0)
    scratch = torch.empty(size, dtype=torch.float32, device=step.device) if size else None
    for (g, m, v, p), ok in zip(flat, inplace):
        if ok:
            tmp = scratch[:g.numel()].view(g.shape)
            _update_inplace(g, m, v, p, tmp, c1, c2, lr, b1, b2, eps, weight_decay)
        else:
            _update_functional(g, m, v, p, c1, c2, lr, b1, b2, eps, weight_decay)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}
