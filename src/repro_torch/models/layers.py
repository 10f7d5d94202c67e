"""Shared building blocks: norms, RoPE, MLPs, embeddings, the cross entropy,
init helpers.

Parameters are the reference's pytrees (``repro.models.layers``): nested
dicts of tensors. Master parameters are in ``param_dtype`` and every
product casts them to the compute dtype (``act_dtype``); a tensor already in
that dtype is used as it is, so a copy of the weights cast once
(``transformer.serving_params``) gives the same values as casting each call.

Every ``init_*`` function takes an explicit ``torch.Generator`` (on the
device the tensors are made on) and a ``lead`` shape prepended to each
parameter's own: the stacked layers of a segment are drawn in one call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..tree import is_distributed


def truncated_normal(generator, shape, scale, dtype, device):
    """``scale`` times a standard normal truncated to [-2, 2], as the
    reference's ``truncated_normal`` (drawn in float32, then cast)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale).to(dtype)


def dense_init(generator, in_dim, out_dim, dtype, device, scale=None, lead=()):
    scale = scale if scale is not None else 1.0 / float(in_dim) ** 0.5
    return truncated_normal(generator, (*lead, in_dim, out_dim), scale, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d, dtype, device, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-5):
    """RMS norm in float32, returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over the two contiguous halves of the head dim.

    x: (..., S, H, hd); positions: broadcastable to (..., S). Angles, cos
    and sin in float32; the result in ``x``'s dtype.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)                # (hd/2,)
    angles = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated SiLU or plain GELU)
# ---------------------------------------------------------------------------

def init_mlp(generator, d_model, d_ff, dtype, device, gated=True, lead=()):
    p = {
        "wi": dense_init(generator, d_model, d_ff, dtype, device, lead=lead),
        "wo": dense_init(generator, d_ff, d_model, dtype, device, lead=lead),
    }
    if gated:
        p["wg"] = dense_init(generator, d_model, d_ff, dtype, device, lead=lead)
    return p


def mlp(params, x, gated=True, act_dtype=torch.bfloat16):
    h = x @ params["wi"].to(act_dtype)
    if gated:
        g = x @ params["wg"].to(act_dtype)
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ params["wo"].to(act_dtype)


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------

def init_embed(generator, vocab, d_model, dtype, device):
    return {"tok": truncated_normal(generator, (vocab, d_model), 1.0, dtype, device)}


def embed(params, tokens, act_dtype=torch.bfloat16):
    return params["tok"][tokens].to(act_dtype)


def lm_logits(head, x, act_dtype=torch.bfloat16):
    return x @ head.to(act_dtype)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, vocab_real: int) -> torch.Tensor:
    """Mean next-token CE in float32; the padded vocabulary columns (past
    ``vocab_real``) are set to -1e30, so they take no probability and no
    gradient."""
    logits = logits.float()
    V = logits.shape[-1]
    if V > vocab_real:
        pad = torch.arange(V, device=logits.device) >= vocab_real
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    if is_distributed(logits):
        # DTensor's gather cannot index a sharded vocabulary: the gold logit
        # is the one nonzero term of a masked sum (a partial sum over the
        # vocabulary's shards), the same value
        hit = torch.arange(V, device=logits.device) == targets[..., None]
        gold = torch.where(hit, logits, 0.0).sum(dim=-1)
    else:
        gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - gold)
