"""Decode-cache layout per architecture family.

The cache mirrors the layer-stack segment structure (see transformer.py):
``{"segments": [ {"s{i}": stacked-cache-per-slot} ]}``, as the reference's
(``repro.models.cache``). The port holds the ``attn`` slot of the dense
family: K/V ring buffers (n_units, B, W, G, hd) in bf16, W = min(attn_window
or max_seq, max_seq). The other slot kinds (mla latents, ssm and rec states)
and the encoder's cross-attention cache wait for ROADMAP item 16b, the
dry run's ``cache_specs`` for item 16d.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .config import require_ported


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


def init_cache(cfg, batch: int, max_seq: int, device="cuda"):
    """Zero-initialized cache (real serving) on ``device``."""
    require_ported(cfg)
    dev = resolve_device(device)
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    W = min(cfg.attn_window, max_seq) if cfg.attn_window else max_seq
    segs = []
    for pattern, n_units in segments_of(cfg):
        shape = (n_units, batch, W, G, hd)
        segs.append({f"s{si}": {name: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                                for name in ("k", "v")}
                     for si, _ in enumerate(pattern)})
    return {"segments": segs}
