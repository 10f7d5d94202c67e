"""Layer-stack assembly: init, prefill, decode.

The stack is decomposed into *segments* of repeating layer-pattern *units*
(see cache.segments_of), as the reference's (``repro.models.transformer``):
uniform archs are one segment of a 1-layer pattern; RecurrentGemma's (rec,
rec, attn) pattern runs 3-layer units with the 2-layer remainder as a
second segment of one unit. Parameters are the reference's tree, each
segment's slots stacked on a leading ``n_units`` axis, so
``convert.lm_params_from_jax`` carries the reference's weights across as
they are; the port runs the units in a Python loop over views of that axis.

Every slot kind runs (attn, mla, ssm, rec; an MoE FFN in place of the MLP;
enc-dec's cross attention over the encoder's output; the VLM's prefix
embeddings), in the ``prefill`` and ``decode`` modes. ``loss_fn`` and the
``train`` mode wait for ROADMAP item 16c.

The cache is written in place: ``prefill`` fills a new cache, and
``decode_step`` writes each unit's new entries into the cache it is given
and returns it. Each leaf keeps the dtype the reference's decode gives it:
the K/V and MLA latents that its one-hot blend writes come back in the
blend's promoted dtype (a float32 model's bf16 cache comes back float32),
the conv tails are cast back to the cache's bf16 every step, the ssm and
rec states stay float32, and the cross-attention K/V are only read.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from . import attention as attn_lib
from . import mla as mla_lib
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import ssm as ssm_lib
from .cache import init_cache, segments_of
from .layers import (
    dense_init,
    embed,
    init_embed,
    init_mlp,
    init_rmsnorm,
    lm_logits,
    mlp,
    rmsnorm,
)

#: the cache leaves the reference's decode writes with its one-hot blend
#: (promoted to the compute dtype); the others keep their dtype
BLENDED = ("k", "v", "c", "r")
#: the parameters that no product reads: kept in their own dtype by
#: ``serving_params`` (norm scales, and the ssm and rec float32 leaves)
F32_LEAVES = ("scale", "norm_scale", "A_log", "D", "dt_bias", "lam")
#: the matrices that products read, each entry once a token (the routed
#: experts' once a token and choice); besides these and F32_LEAVES the tree
#: holds the embeddings (``tok``, ``head``), biases and conv taps
PRODUCT_LEAVES = ("wq", "wk", "wv", "wo", "wi", "wg", "router", "w_dkv", "w_krope", "k_up",
                  "v_up", "in_proj", "out_proj", "w_gate", "w_rec_in", "w_r", "w_i")


def _act_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_slot(generator, cfg, kind, dtype, device, lead):
    p = {"ln1": init_rmsnorm(cfg.d_model, dtype, device, lead)}
    if kind == "attn":
        p["mix"] = attn_lib.init_attention(generator, cfg, dtype, device, lead)
        if cfg.family == "encdec":
            p["cross"] = attn_lib.init_attention(generator, cfg, dtype, device, lead)
            p["ln_x"] = init_rmsnorm(cfg.d_model, dtype, device, lead)
    elif kind == "mla":
        p["mix"] = mla_lib.init_mla(generator, cfg, dtype, device, lead)
    elif kind == "ssm":
        p["mix"] = ssm_lib.init_ssm(generator, cfg, dtype, device, lead)
    elif kind == "rec":
        p["mix"] = rglru_lib.init_rglru(generator, cfg, dtype, device, lead)
    else:
        raise ValueError(kind)

    if kind != "ssm":  # mamba2 blocks have no separate FFN
        p["ln2"] = init_rmsnorm(cfg.d_model, dtype, device, lead)
        if cfg.moe_num_experts:
            p["moe"] = moe_lib.init_moe(generator, cfg, dtype, device, lead)
        elif cfg.d_ff:
            p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device,
                                cfg.gated_mlp, lead)
    return p


def _init_tree(cfg, generator, device):
    dtype = torch.float32 if cfg.param_dtype == "float32" else torch.bfloat16
    params = {"embed": init_embed(generator, cfg.padded_vocab, cfg.d_model, dtype, device)}
    params["segments"] = [
        {f"s{si}": _init_slot(generator, cfg, kind, dtype, device, (n_units,))
         for si, kind in enumerate(pattern)}
        for pattern, n_units in segments_of(cfg)]
    params["final_norm"] = init_rmsnorm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, cfg.d_model, cfg.padded_vocab, dtype, device)
    if cfg.family == "encdec":
        lead = (cfg.enc_layers,)
        params["encoder"] = {
            "layers": {"ln1": init_rmsnorm(cfg.d_model, dtype, device, lead),
                       "mix": attn_lib.init_attention(generator, cfg, dtype, device, lead),
                       "ln2": init_rmsnorm(cfg.d_model, dtype, device, lead),
                       "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device,
                                       cfg.gated_mlp, lead)},
            "final_norm": init_rmsnorm(cfg.d_model, dtype, device)}
    return params


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Master parameters (``param_dtype``) on ``device``, drawn from
    ``generator``, a ``torch.Generator`` on that device: the reference's
    tree and inits (truncated normals, ``1/sqrt(fan_in)``), in the port's
    own draw order."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the parameters "
                         f"go to {dev}: draw them on one device")
    return _init_tree(cfg, generator, dev)


def param_shapes(cfg):
    """The parameter tree of ``cfg`` with each leaf's ``torch.Size``
    (nothing is allocated)."""
    return _map(lambda t: t.shape, _init_tree(cfg, None, torch.device("meta")))


def serving_params(params, cfg):
    """``params`` with every weight that a product reads cast once to the
    compute dtype (``cfg.dtype``); the leaves of :data:`F32_LEAVES` stay as
    they are, since the reference reads them in their own dtype. Each
    product's ``.to(act_dtype)`` is then a no-op, and the values are those
    of casting each call."""
    act = _act_dtype(cfg)

    def cast(tree):
        if isinstance(tree, dict):
            return {k: v if k in F32_LEAVES else cast(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.to(act)
    return cast(params)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _fill(dst, src):
    """Copy the sequence (B, S, ...) into a new cache leaf (B, W, ...): its
    first W positions (the leaf stays zero past S)."""
    W, S = dst.shape[1], src.shape[1]
    dst[:, :min(S, W)].copy_(src[:, :W])


def _ffn(p, cfg, x, act):
    if "moe" in p:
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + moe_lib.moe_forward(p["moe"], h2, cfg, act_dtype=act)[0]
    elif "mlp" in p:
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h2, cfg.gated_mlp, act_dtype=act)
    return x


def _block_full(p, cfg, kind, x, positions, enc_out, slot_cache):
    """Full-sequence block (prefill); writes the slot's cache entries into
    ``slot_cache``. Returns x."""
    act = _act_dtype(cfg)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        out, (k, v) = attn_lib.attention_forward(p["mix"], h, cfg, positions, act_dtype=act)
        W = slot_cache["k"].shape[1]
        S = k.shape[1]
        for name, new in (("k", k), ("v", v)):
            if S >= W:
                # ring semantics: decode writes slot = pos % W, so the last W
                # keys must land at slots (S-W+i) % W, i.e. roll by S % W
                new = torch.roll(new[:, -W:], S % W, dims=1)
            _fill(slot_cache[name], new)
    elif kind == "mla":
        out, (c_kv, k_rope) = mla_lib.mla_forward(p["mix"], h, cfg, positions, act_dtype=act)
        _fill(slot_cache["c"], c_kv)
        _fill(slot_cache["r"], k_rope)
    elif kind == "ssm":
        out, (conv, state) = ssm_lib.ssm_forward(p["mix"], h, cfg, act_dtype=act)
        slot_cache["conv"].copy_(conv)
        slot_cache["state"].copy_(state)
    elif kind == "rec":
        out, (conv, hstate) = rglru_lib.rglru_forward(p["mix"], h, cfg, act_dtype=act)
        slot_cache["conv"].copy_(conv)
        slot_cache["h"].copy_(hstate)
    else:
        raise ValueError(kind)
    x = x + out

    if "cross" in p and enc_out is not None:
        hx = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        cx, (ck, cv) = _cross_attention(p["cross"], hx, enc_out, cfg, act)
        x = x + cx
        slot_cache["ck"].copy_(ck)
        slot_cache["cv"].copy_(cv)
    return _ffn(p, cfg, x, act)


def _block_decode(p, cfg, kind, x, positions, slot_cache):
    """Single-token block; writes the slot's new entries into ``slot_cache``
    in place (the blended leaves already in their promoted dtype, see
    ``_run_segments``). Returns x."""
    act = _act_dtype(cfg)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    c = slot_cache
    if kind == "attn":
        W = c["k"].shape[1]
        cache_pos = positions % W if cfg.attn_window else positions
        out, _, _ = attn_lib.attention_decode(p["mix"], h, cfg, positions, c["k"], c["v"],
                                              cache_pos, act_dtype=act)
    elif kind == "mla":
        out, _, _ = mla_lib.mla_decode(p["mix"], h, cfg, positions, c["c"], c["r"],
                                       positions, act_dtype=act)
    elif kind == "ssm":
        out, (conv, state) = ssm_lib.ssm_decode(p["mix"], h, cfg, c["conv"], c["state"],
                                                act_dtype=act)
        c["conv"].copy_(conv)
        c["state"].copy_(state)
    elif kind == "rec":
        out, (conv, hstate) = rglru_lib.rglru_decode(p["mix"], h, cfg, c["conv"], c["h"],
                                                     act_dtype=act)
        c["conv"].copy_(conv)
        c["h"].copy_(hstate)
    else:
        raise ValueError(kind)
    x = x + out

    if "cross" in p:
        hx = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        x = x + _cross_decode(p["cross"], hx, c["ck"], c["cv"], cfg, act)
    return _ffn(p, cfg, x, act)


def _cross_attention(p, x, enc_out, cfg, act):
    """Non-causal cross attention; k/v from the encoder output (no rope)."""
    B, S, _ = x.shape
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    Se = enc_out.shape[1]
    q = (x @ p["wq"].to(act)).reshape(B, S, H, hd)
    k = (enc_out @ p["wk"].to(act)).reshape(B, Se, G, hd)
    v = (enc_out @ p["wv"].to(act)).reshape(B, Se, G, hd)
    qp = torch.arange(S, device=x.device).expand(B, S)
    kp = torch.arange(Se, device=x.device).expand(B, Se)
    out = attn_lib._sdpa_chunked(q, k, v, qp, kp, causal=False, window=0,
                                 q_chunk=cfg.blockwise_q, kv_chunk=cfg.blockwise_kv)
    return out.reshape(B, S, H * hd) @ p["wo"].to(act), (k, v)


def _cross_decode(p, x, ck, cv, cfg, act):
    B = x.shape[0]
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rep = H // G
    kf = ck.float().repeat_interleave(rep, dim=2)
    vf = cv.float().repeat_interleave(rep, dim=2)
    q = (x @ p["wq"].to(act)).reshape(B, H, hd)
    s = torch.einsum("bhd,bkhd->bhk", q.float() / attn_lib.sqrt_f32(hd), kf)
    out = torch.einsum("bhk,bkhd->bhd", torch.softmax(s, dim=-1), vf)
    return out.reshape(B, 1, H * hd).to(act) @ p["wo"].to(act)


# ---------------------------------------------------------------------------
# stack runner
# ---------------------------------------------------------------------------

def _run_segments(params, cfg, x, positions, cache, enc_out, mode):
    """mode: 'prefill' | 'decode'. Returns (x, cache)."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} is not ported yet (ROADMAP item 16c)")
    act = _act_dtype(cfg)
    segments = []
    for gi, (pattern, n_units) in enumerate(segments_of(cfg)):
        seg_params = params["segments"][gi]
        seg_cache = cache["segments"][gi]
        if mode == "decode":
            # the reference's blend promotes these leaves to the compute
            # dtype; promoting the stack once lets every unit write its view
            seg_cache = {s: {n: t.to(torch.promote_types(t.dtype, act)) if n in BLENDED else t
                             for n, t in c.items()} for s, c in seg_cache.items()}
        for u in range(n_units):
            for si, kind in enumerate(pattern):
                sp = _map(lambda t: t[u], seg_params[f"s{si}"])
                sc = {n: t[u] for n, t in seg_cache[f"s{si}"].items()}
                if mode == "decode":
                    x = _block_decode(sp, cfg, kind, x, positions, sc)
                else:
                    x = _block_full(sp, cfg, kind, x, positions, enc_out, sc)
        segments.append(seg_cache)
    return x, {"segments": segments}


def _encode(params, cfg, enc_embeds):
    """Whisper-style encoder over precomputed frame embeddings (stub frontend)."""
    act = _act_dtype(cfg)
    x = enc_embeds.to(act)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    layers = params["encoder"]["layers"]
    for u in range(cfg.enc_layers):
        p = _map(lambda t: t[u], layers)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = attn_lib._project_qkv(p["mix"], h, cfg, positions, act)
        out = attn_lib._sdpa_chunked(q, k, v, positions, positions, causal=False, window=0,
                                     q_chunk=cfg.blockwise_q, kv_chunk=cfg.blockwise_kv)
        x = x + out.reshape(B, S, -1) @ p["mix"]["wo"].to(act)
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h2, cfg.gated_mlp, act_dtype=act)
    return rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def _embed_inputs(params, cfg, tokens, batch):
    act = _act_dtype(cfg)
    x = embed(params["embed"], tokens, act_dtype=act)
    if cfg.family == "vlm" and "prefix_embeds" in batch:
        P = cfg.num_prefix_tokens
        x = torch.cat([batch["prefix_embeds"].to(act), x[:, P:]], dim=1)
    return x


def _logits(params, cfg, x):
    head = params["head"] if "head" in params else params["embed"]["tok"].T
    return lm_logits(head, x, act_dtype=_act_dtype(cfg))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def prefill(params, cfg, batch, max_seq: Optional[int] = None):
    """Process a full prompt; returns (last-token logits, cache).

    ``batch["tokens"]``: (B, S) integer tensor on the parameters' device;
    an enc-dec model reads ``batch["enc_embeds"]`` (B, enc_seq, d_model), a
    VLM takes ``batch["prefix_embeds"]`` (B, num_prefix_tokens, d_model)
    in place of its first tokens' embeddings where the batch has them. The
    cache holds ``max_seq`` (default S) positions.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    cache = init_cache(cfg, batch=B, max_seq=max_seq or S, device=tokens.device)
    x = _embed_inputs(params, cfg, tokens, batch)
    enc_out = _encode(params, cfg, batch["enc_embeds"]) if cfg.family == "encdec" else None
    x, cache = _run_segments(params, cfg, x, positions, cache, enc_out, "prefill")
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache


def decode_step(params, cfg, tokens, positions, cache):
    """One AR step for a batch. tokens: (B,1); positions: (B,). The new
    entries go into ``cache`` in place; returns (logits, cache)."""
    x = embed(params["embed"], tokens, act_dtype=_act_dtype(cfg))
    x, cache = _run_segments(params, cfg, x, positions, cache, None, "decode")
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache
