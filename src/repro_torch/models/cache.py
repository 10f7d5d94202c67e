"""Decode-cache layout per architecture family.

The cache mirrors the layer-stack segment structure (see transformer.py):
``{"segments": [ {"s{i}": stacked-cache-per-slot} ]}``, as the reference's
(``repro.models.cache``). Per slot, each leaf stacked on a leading
``n_units`` axis:

  attn : k/v ring buffers (B, W, G, hd), W = min(attn_window or S, S);
         enc-dec adds the cross-attention ck/cv (B, enc_seq, G, hd)
  mla  : latent c (B, S, kv_lora) and shared rope key r (B, S, rope_dim);
         not a ring
  ssm  : conv tail (B, K-1, d_in + 2N) and SSD state (B, nh, P, N)
  rec  : conv tail (B, K-1, R) and RG-LRU state h (B, R)

SSM/rec states are float32, everything else bf16, as the reference's.
``cache_specs`` builds the same tree on the meta device (the dry run's
shapes and dtypes; nothing is allocated).
"""

from __future__ import annotations

import torch

from ..device import resolve_device


def segments_of(cfg):
    """[(pattern_tuple, n_units)] decomposition of the layer stack."""
    if cfg.family == "hybrid" and cfg.hybrid_pattern:
        p = len(cfg.hybrid_pattern)
        n_units, rem = divmod(cfg.num_layers, p)
        segs = []
        if n_units:
            segs.append((tuple(cfg.hybrid_pattern), n_units))
        if rem:
            segs.append((tuple(cfg.hybrid_pattern[:rem]), 1))
        return segs
    kind = {"ssm": "ssm"}.get(cfg.family, "attn")
    if cfg.family == "moe" and cfg.mla_kv_lora:
        kind = "mla"
    return [((kind,), cfg.num_layers)]


def _slot_shapes(cfg, kind, batch, max_seq) -> dict:
    """``{leaf: (shape, dtype)}`` of one slot's cache."""
    B = batch
    bf16, f32 = torch.bfloat16, torch.float32
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if kind == "attn":
        W = min(cfg.attn_window, max_seq) if cfg.attn_window else max_seq
        c = {"k": ((B, W, G, hd), bf16), "v": ((B, W, G, hd), bf16)}
        if cfg.family == "encdec":
            c["ck"] = ((B, cfg.enc_seq, G, hd), bf16)
            c["cv"] = ((B, cfg.enc_seq, G, hd), bf16)
        return c
    if kind == "mla":
        return {"c": ((B, max_seq, cfg.mla_kv_lora), bf16),
                "r": ((B, max_seq, cfg.mla_rope_dim), bf16)}
    if kind == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        nh = d_in // cfg.ssm_head_dim
        return {"conv": ((B, cfg.ssm_conv - 1, d_in + 2 * cfg.ssm_state), bf16),
                "state": ((B, nh, cfg.ssm_head_dim, cfg.ssm_state), f32)}
    if kind == "rec":
        R = cfg.rnn_width or cfg.d_model
        return {"conv": ((B, cfg.ssm_conv - 1, R), bf16), "h": ((B, R), f32)}
    raise ValueError(kind)


def zero_cache(cfg, batch, max_seq, dev: torch.device):
    """The zero cache tree on ``dev`` as given (the meta device too)."""
    return {"segments": [
        {f"s{si}": {name: torch.zeros((n_units, *shape), dtype=dtype, device=dev)
                    for name, (shape, dtype) in _slot_shapes(cfg, kind, batch, max_seq).items()}
         for si, kind in enumerate(pattern)}
        for pattern, n_units in segments_of(cfg)]}


def cache_specs(cfg, batch: int, max_seq: int):
    """The cache tree of :func:`init_cache` as meta tensors (dry run; no
    allocation)."""
    return zero_cache(cfg, batch, max_seq, torch.device("meta"))


def init_cache(cfg, batch: int, max_seq: int, device="cuda"):
    """Zero-initialized cache (real serving) on ``device``."""
    return zero_cache(cfg, batch, max_seq, resolve_device(device))
