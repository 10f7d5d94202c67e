"""Attention: GQA/MQA with RoPE, blockwise (flash-style) prefill, windowed
local attention, and single-token decode against a KV cache.

The reference (``repro.models.attention``) chooses its layout from the
device mesh; on one device (no model axis) it takes the grouped
``(G, rep)`` layout whenever H != G, and the H-space one, the same
arithmetic, when H == G. The port has that one layout: query head h reads
KV group ``h // rep``. Prefill is the reference's online softmax over
query chunks x key chunks (``blockwise_q`` x ``blockwise_kv``), padded to
chunk multiples with query positions -1 and key positions 2**30; scores,
softmax and the PV product are float32, masked with -1e30 (not -inf, so a
chunk that a row sees none of leaves no NaN), as the reference's.
``attn_probs_bf16`` rounds p and v to bf16 before the PV product, which
accumulates in float32; the reference takes it on its H-space path only,
so on one device it holds where H == G and the grouped layout ignores it,
and the port does the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..tree import is_distributed
from . import sharding
from .layers import apply_rope, dense_init
from .sharding import logical_constraint as _lc
from .sharding import model_axis_size

NEG_INF = -1e30


def init_attention(generator, cfg, dtype, device, lead=()):
    D = cfg.d_model
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": dense_init(generator, D, H * hd, dtype, device, lead=lead),
        "wk": dense_init(generator, D, G * hd, dtype, device, lead=lead),
        "wv": dense_init(generator, D, G * hd, dtype, device, lead=lead),
        "wo": dense_init(generator, H * hd, D, dtype, device, lead=lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", G * hd), ("bv", G * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=device)
    return p


def _project_qkv(params, x, cfg, positions, act_dtype):
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"].to(act_dtype)
    k = x @ params["wk"].to(act_dtype)
    v = x @ params["wv"].to(act_dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(act_dtype)
        k = k + params["bk"].to(act_dtype)
        v = v + params["bv"].to(act_dtype)
    q = split_heads(q, H, hd)
    k = split_heads(k, G, hd)
    v = split_heads(v, G, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = _lc(q, "batch", None, "heads", None)
    k = _lc(k, "batch", None, "heads", None)   # no-op where G % tp != 0
    v = _lc(v, "batch", None, "heads", None)
    return q, k, v


def split_heads(t, n, hd):
    """(..., n * hd) -> (..., n, hd). Under a model axis that n does not
    divide, a feature axis sharded on it has no placement once split, so it
    is replicated first (and its gradient with it)."""
    tp = model_axis_size()
    if tp and n % tp:
        t = _lc(t, *(["batch"] + [None] * (t.ndim - 1)))
    return t.reshape(*t.shape[:-1], n, hd)


def merge_heads(t):
    """(..., n, hd) -> (..., n * hd), :func:`split_heads` undone. Under a
    model axis that n does not divide, the merged axis is held whole, and
    so is its gradient: the product after it would return that gradient
    sharded on the merged axis, which DTensor cannot split into the heads."""
    n = t.shape[-2]
    t = t.reshape(*t.shape[:-2], n * t.shape[-1])
    tp = model_axis_size()
    if tp and n % tp:
        t = _lc(t, *(["batch"] + [None] * (t.ndim - 1)))
    return t


def _grouped(q, G):
    """q (B, S, H, hd) as the grouped layout reads it. Under a model axis
    that G does not divide, a head axis sharded on it has no placement once
    split into (G, rep), so q's heads are replicated first (the layout's
    cost where the reference repeats K/V to H heads instead)."""
    tp = model_axis_size()
    if tp and G % tp:
        q = _lc(q, "batch", None, None, None)
    return q


def _inv_sqrt(hd: int) -> float:
    """1 / sqrt(hd) rounded as the reference rounds it: both steps in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def sqrt_f32(hd: int) -> float:
    """sqrt(hd) rounded to float32, as the reference's ``jnp.sqrt(hd)``."""
    return float(np.sqrt(np.float32(hd)))


def _sdpa_chunked(q, k, v, q_pos, k_pos, *, causal, window, q_chunk, kv_chunk,
                  probs_bf16=False):
    """Online-softmax attention. q: (B,Sq,H,dk); k: (B,Sk,G,dk); v: (B,Sk,G,dv).

    dk may differ from dv (MLA concatenates rope dims into q/k only).
    ``probs_bf16`` (taken where H == G, see the module's docstring): p and v
    rounded to bf16, their products summed in float32. Returns (B, Sq, H,
    dv) in q's dtype. DTensor operands run :func:`_sdpa_local` on each
    rank's shards (:func:`_sdpa_on_mesh`).
    """
    kw = dict(causal=causal, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
              probs_bf16=probs_bf16)
    if is_distributed(q):
        return _sdpa_on_mesh(q, k, v, q_pos, k_pos, **kw)
    return _sdpa_local(q, k, v, q_pos, k_pos, **kw)


def _sdpa_on_mesh(q, k, v, q_pos, k_pos, **kw):
    """:func:`_sdpa_local` of DTensor operands on each rank's own shards
    (``sharding.on_shards``): the batch on the batch axes, the KV groups
    (and their query heads) on the model axis where the groups divide it,
    else every head whole on each rank, as :func:`_grouped` places q."""
    mesh = q.device_mesh
    heads = "heads" if k.shape[2] % sharding.mesh_sizes(mesh).get("model", 1) == 0 else None
    qkv = ("batch", None, heads, None)
    return sharding.on_shards(
        functools.partial(_sdpa_local, **kw), (q, k, v, q_pos, k_pos),
        (qkv, qkv, qkv, ("batch", None), ("batch", None)),
        sharding.role_placements(qkv, q.shape, mesh))


def _sdpa_local(q, k, v, q_pos, k_pos, *, causal, window, q_chunk, kv_chunk,
                probs_bf16=False):
    """:func:`_sdpa_chunked` of plain tensors."""
    B, Sq, H, hd = q.shape
    _, Sk, G, _ = k.shape
    dv = v.shape[-1]
    rep = H // G
    scale = _inv_sqrt(hd)
    probs_bf16 = probs_bf16 and rep == 1
    q = _grouped(q, G)

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq = (Sq + q_chunk - 1) // q_chunk
    nk = (Sk + kv_chunk - 1) // kv_chunk
    q = _pad_axis(q, nq * q_chunk, 1)
    k = _pad_axis(k, nk * kv_chunk, 1)
    v = _pad_axis(v, nk * kv_chunk, 1)
    q_pos = _pad_axis(q_pos, nq * q_chunk, 1, fill=-1)        # (B, Sq)
    k_pos = _pad_axis(k_pos, nk * kv_chunk, 1, fill=2**30)    # (B, Sk)

    qc = q.reshape(B, nq, q_chunk, H, hd).permute(1, 0, 3, 2, 4)   # (nq,B,H,qc,hd)
    kc = k.reshape(B, nk, kv_chunk, G, hd).permute(1, 0, 3, 2, 4)  # (nk,B,G,kc,hd)
    vc = v.reshape(B, nk, kv_chunk, G, dv).permute(1, 0, 3, 2, 4)
    qpc = q_pos.reshape(B, nq, q_chunk).permute(1, 0, 2)
    kpc = k_pos.reshape(B, nk, kv_chunk).permute(1, 0, 2)

    outs = []
    for i in range(nq):
        qg = (qc[i].float() * scale).reshape(B, G, rep, q_chunk, hd)
        dq = qpc[i][:, None, None, :, None]
        m = torch.full((B, G, rep, q_chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, G, rep, q_chunk, dv), dtype=torch.float32, device=q.device)
        for j in range(nk):
            s = _lc(torch.einsum("bgrqd,bgkd->bgrqk", qg, kc[j].float()),
                    "batch", "heads", None, None, None)
            dk = kpc[j][:, None, None, None, :]
            mask = torch.ones((B, 1, 1, q_chunk, kv_chunk), dtype=torch.bool, device=q.device)
            if causal:
                mask = mask & (dk <= dq)
            if window:
                mask = mask & (dq - dk < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            vj = vc[j]
            if probs_bf16:  # a product of two bf16 values is exact in float32
                p, vj = p.to(torch.bfloat16).float(), vj.to(torch.bfloat16)
            acc = acc * corr[..., None] + torch.einsum("bgrqk,bgkd->bgrqd", p, vj.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.reshape(B, H, q_chunk, dv).to(q.dtype))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, nq * q_chunk, H, dv)
    return out[:, :Sq]


def _pad_axis(x, size, axis, fill=0):
    if x.shape[axis] == size:
        return x
    shape = list(x.shape)
    shape[axis] = size - x.shape[axis]
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=axis)


def attention_forward(params, x, cfg, positions, *, act_dtype=torch.bfloat16):
    """Full-sequence causal attention (prefill).

    Returns (out, (k, v)), k and v (B, S, G, hd) for the cache.
    """
    q, k, v = _project_qkv(params, x, cfg, positions, act_dtype)
    out = _sdpa_chunked(q, k, v, positions, positions, causal=True,
                        window=cfg.attn_window, q_chunk=cfg.blockwise_q,
                        kv_chunk=cfg.blockwise_kv, probs_bf16=cfg.attn_probs_bf16)
    out = merge_heads(out) @ params["wo"].to(act_dtype)
    return out, (k, v)


def blend_write(cache, new, cache_pos):
    """Write ``new`` (B, ...) into ``cache`` (B, W, ...) at ``cache_pos`` (B,),
    as the reference's one-hot blend ``cache * (1 - oh) + oh * new``: at the
    dtype the blend gives (the two dtypes' promotion: a float32 model's bf16
    cache is promoted first, into a new tensor), in place, and a position
    outside [0, W) writes nothing, as the blend's all-zero row. Returns the
    cache written. A DTensor cache (sharded on its batch, heads or sequence
    axis) is written by a masked select of the whole cache, copied back in
    place: DTensor has no in-place indexed write that keeps a sharded
    placement. The values are the same."""
    dt = torch.promote_types(cache.dtype, new.dtype)
    if cache.dtype != dt:
        cache = cache.to(dt)
    B, W = cache.shape[:2]
    if is_distributed(cache):
        hit = torch.arange(W, device=cache_pos.device)[None, :] == cache_pos[:, None]
        cache.copy_(torch.where(hit.reshape(B, W, *([1] * (new.dim() - 1))),
                                new.to(dt)[:, None], cache))
        return cache
    rows = torch.arange(B, device=cache.device)
    inside = ((cache_pos >= 0) & (cache_pos < W)).reshape(B, *([1] * (new.dim() - 1)))
    at = cache_pos.clamp(0, W - 1)
    cache[rows, at] = torch.where(inside, new.to(dt), cache[rows, at])
    return cache


def attention_decode(params, x, cfg, positions, k_cache, v_cache, cache_pos, *,
                     act_dtype=torch.bfloat16):
    """One-token decode. x: (B,1,D); k/v_cache: (B,W,G,hd) ring buffers.

    ``positions`` (B,) absolute positions; ``cache_pos`` (B,) write slot
    (== positions for a full cache, positions % window for ring buffers).
    The new K/V are written into the caches by :func:`blend_write`.
    Returns (out, k_cache, v_cache).
    """
    B = x.shape[0]
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q, k, v = _project_qkv(params, x, cfg, positions[:, None], act_dtype)

    k_cache = blend_write(k_cache, k[:, 0], cache_pos)
    v_cache = blend_write(v_cache, v[:, 0], cache_pos)
    W = k_cache.shape[1]

    rep = H // G
    kf = k_cache.float()
    vf = v_cache.float()
    slot = torch.arange(W, device=x.device)[None, :]              # (1, W)
    if cfg.attn_window:
        written = slot < torch.clamp_max(positions[:, None] + 1, W)
    else:
        written = slot <= positions[:, None]

    qg = (_grouped(q, G).float() / sqrt_f32(hd))[:, 0].reshape(B, G, rep, hd)
    s = _lc(torch.einsum("bgrd,bkgd->bgrk", qg, kf), "batch", "heads", None, None)
    s = torch.where(written[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, vf).reshape(B, H, hd)
    out = out.reshape(B, 1, H * hd).to(act_dtype) @ params["wo"].to(act_dtype)
    return out, k_cache, v_cache
