"""Multi-head Latent Attention (DeepSeek-V2): low-rank compressed KV cache.

The reference's (``repro.models.mla``). Prefill materializes per-head K/V
from the compressed latent and runs the chunked online softmax
(``attention._sdpa_chunked``, with dk = hd + R and dv = hd). Decode is the
*absorbed* form: ``k_up`` is folded into the query, so the scores are taken
against the (B, S, kv_lora) latent cache and the shared rope key, and
``v_up`` is applied after the softmax; the cache holds ``kv_lora +
rope_dim`` values a position instead of ``2 * H * hd``.
"""

from __future__ import annotations

import torch

from .attention import NEG_INF, _inv_sqrt, _sdpa_chunked, blend_write, merge_heads
from .layers import apply_rope, dense_init


def init_mla(generator, cfg, dtype, device, lead=()):
    D = cfg.d_model
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    L, R = cfg.mla_kv_lora, cfg.mla_rope_dim
    return {
        "wq": dense_init(generator, D, H * (hd + R), dtype, device, lead=lead),
        "w_dkv": dense_init(generator, D, L, dtype, device, lead=lead),
        "w_krope": dense_init(generator, D, R, dtype, device, lead=lead),
        "k_up": dense_init(generator, L, H * hd, dtype, device, lead=lead),
        "v_up": dense_init(generator, L, H * hd, dtype, device, lead=lead),
        "wo": dense_init(generator, H * hd, D, dtype, device, lead=lead),
    }


def _project_q(params, x, cfg, positions, act_dtype):
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    R = cfg.mla_rope_dim
    q = (x @ params["wq"].to(act_dtype)).reshape(B, S, H, hd + R)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_forward(params, x, cfg, positions, act_dtype=torch.bfloat16):
    """Prefill. Returns (out, (c_kv (B,S,L), k_rope (B,S,R))) for the cache."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    R = cfg.mla_rope_dim

    q_nope, q_rope = _project_q(params, x, cfg, positions, act_dtype)
    c_kv = x @ params["w_dkv"].to(act_dtype)                              # (B,S,L)
    k_rope = (x @ params["w_krope"].to(act_dtype))[:, :, None, :]         # (B,S,1,R)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)

    k_nope = (c_kv @ params["k_up"].to(act_dtype)).reshape(B, S, H, hd)
    v = (c_kv @ params["v_up"].to(act_dtype)).reshape(B, S, H, hd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, R)], dim=-1)
    out = _sdpa_chunked(q, k, v, positions, positions, causal=True, window=0,
                        q_chunk=cfg.blockwise_q, kv_chunk=cfg.blockwise_kv)
    out = merge_heads(out) @ params["wo"].to(act_dtype)
    return out, (c_kv, k_rope[:, :, 0, :])


def mla_decode(params, x, cfg, positions, c_cache, r_cache, cache_pos,
               act_dtype=torch.bfloat16):
    """Absorbed single-token decode against the latent cache.

    x: (B,1,D); c_cache: (B,W,L) latent; r_cache: (B,W,R) shared rope key;
    the new latent and rope key are written at ``cache_pos`` by
    ``attention.blend_write`` (a position at or past W writes nothing).
    Returns (out, c_cache, r_cache).
    """
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    L, R = cfg.mla_kv_lora, cfg.mla_rope_dim

    q_nope, q_rope = _project_q(params, x, cfg, positions[:, None], act_dtype)
    c_new = x[:, 0] @ params["w_dkv"].to(act_dtype)                       # (B,L)
    r_new = apply_rope((x @ params["w_krope"].to(act_dtype))[:, :, None, :],
                       positions[:, None], cfg.rope_theta)[:, 0, 0]       # (B,R)
    c_cache = blend_write(c_cache, c_new, cache_pos)
    r_cache = blend_write(r_cache, r_new, cache_pos)

    W = c_cache.shape[1]
    k_up = params["k_up"].to(act_dtype).reshape(L, H, hd)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0], k_up)              # (B,H,L)
    cf = c_cache.float()
    s = torch.einsum("bhl,bwl->bhw", q_lat.float(), cf)
    s = s + torch.einsum("bhr,bwr->bhw", q_rope[:, 0].float(), r_cache.float())
    s = s * _inv_sqrt(hd + R)
    valid = torch.arange(W, device=x.device)[None, :] <= positions[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhw,bwl->bhl", p, cf)                             # (B,H,L)
    v_up = params["v_up"].to(act_dtype).reshape(L, H, hd)
    out = torch.einsum("bhl,lhd->bhd", ctx.to(act_dtype), v_up)
    out = out.reshape(B, 1, H * hd) @ params["wo"].to(act_dtype)
    return out, c_cache, r_cache
