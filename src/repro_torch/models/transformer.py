"""Layer-stack assembly: init, the train forward and its loss, prefill, decode.

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
embeddings), in the ``train``, ``prefill`` and ``decode`` modes.

Training (``loss_fn``) runs the ``train`` mode under autograd, with no
cache. Each segment's stacked leaves are unbound once along the units
(``_units``), so a unit's parameters are views whose gradients autograd
stacks back into one tensor a leaf (slicing each unit out of the stack
would make each unit's backward write a zero tensor the size of the whole
stack). ``cfg.remat`` wraps each unit in a non-reentrant
``torch.utils.checkpoint``: ``"full"`` recomputes the unit in the backward
pass, ``"dots"`` saves the outputs of its plain (non-batched) matrix
products and recomputes the rest (the reference's
``dots_with_no_batch_dims_saveable``), ``"none"`` saves everything.

The cache is written in place: ``prefill`` fills a new cache, and
``decode_step`` writes each unit's new entries into the cache it is given
and returns it. Each leaf keeps the dtype the reference's decode gives it:
the K/V and MLA latents that its one-hot blend writes come back in the
blend's promoted dtype (a float32 model's bf16 cache comes back float32),
the conv tails are cast back to the cache's bf16 every step, the ssm and
rec states stay float32, and the cross-attention K/V are only read.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve_device
from ..tree import is_distributed, tree_map
from . import attention as attn_lib
from . import mla as mla_lib
from . import moe as moe_lib
from . import rglru as rglru_lib
from . import ssm as ssm_lib
from .cache import cache_specs, init_cache, segments_of
from .sharding import cache_shardings
from .sharding import logical_constraint as _lc
from .layers import (
    cross_entropy,
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


def meta_params(cfg):
    """The parameter tree of ``cfg`` as meta tensors: each leaf's shape and
    ``param_dtype``, nothing allocated (the dry run's parameters)."""
    return _init_tree(cfg, None, torch.device("meta"))


def param_shapes(cfg):
    """The parameter tree of ``cfg`` with each leaf's ``torch.Size``
    (nothing is allocated)."""
    return tree_map(lambda t: t.shape, meta_params(cfg))


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


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _fill(dst, src):
    """Copy the sequence (B, S, ...) into a new cache leaf (B, W, ...): its
    first W positions (the leaf stays zero past S)."""
    W, S = dst.shape[1], src.shape[1]
    dst[:, :min(S, W)].copy_(src[:, :W])


def _residual(x, out):
    """``x + out``, the residual stream, placed whole on each rank but for
    its batch, as at a unit's start. (Under a mesh a sum from the model
    axis would otherwise come back sharded on the sequence, and the next
    products would flatten a batch and a sequence sharded on different
    axes, whose placements DTensor takes minutes an operation to plan on a
    3-D mesh.) On plain tensors it is the sum itself."""
    return _lc(x + out, "batch", None, None)


def _ffn(p, cfg, x, act):
    """The block's FFN half. Returns ``(x, aux)``: the MoE's load-balance
    loss, None without an MoE (the reference adds a float32 zero)."""
    aux = None
    if "moe" in p:
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        out2, aux = moe_lib.moe_forward(p["moe"], h2, cfg, act_dtype=act)
        x = _residual(x, out2)
    elif "mlp" in p:
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = _residual(x, mlp(p["mlp"], h2, cfg.gated_mlp, act_dtype=act))
    return x, aux


def _block_full(p, cfg, kind, x, positions, enc_out, slot_cache):
    """Full-sequence block (train, prefill). With a ``slot_cache`` (prefill)
    the slot's cache entries are written into it (:func:`_write_slot`);
    with None (train) nothing is written. Returns ``(x, aux)`` (see
    :func:`_ffn`)."""
    act = _act_dtype(cfg)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        out, (k, v) = attn_lib.attention_forward(p["mix"], h, cfg, positions, act_dtype=act)
        new = {"k": k, "v": v}
    elif kind == "mla":
        out, (c_kv, k_rope) = mla_lib.mla_forward(p["mix"], h, cfg, positions, act_dtype=act)
        new = {"c": c_kv, "r": k_rope}
    elif kind == "ssm":
        out, (conv, state) = ssm_lib.ssm_forward(p["mix"], h, cfg, act_dtype=act)
        new = {"conv": conv, "state": state}
    elif kind == "rec":
        out, (conv, hstate) = rglru_lib.rglru_forward(p["mix"], h, cfg, act_dtype=act)
        new = {"conv": conv, "h": hstate}
    else:
        raise ValueError(kind)
    x = _residual(x, out)

    if "cross" in p and enc_out is not None:
        hx = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        cx, (new["ck"], new["cv"]) = _cross_attention(p["cross"], hx, enc_out, cfg, act)
        x = _residual(x, cx)
    if slot_cache is not None:
        _write_slot(slot_cache, new)
    return _ffn(p, cfg, x, act)


def _write_slot(slot_cache, new):
    """A prefill's entries into its slot's new cache: the K/V and MLA
    latents as sequences (:func:`_fill`; a K/V ring of W slots takes the
    last W keys, rolled so that decode's slot = pos % W holds), the conv
    tails, states and cross K/V copied."""
    for name, t in new.items():
        if name in ("k", "v"):
            W, S = slot_cache[name].shape[1], t.shape[1]
            if S >= W:
                t = t[:, -W:]
                if S % W:  # (a roll by 0 is the identity)
                    t = torch.roll(t, S % W, dims=1)
        if name in ("k", "v", "c", "r"):
            _fill(slot_cache[name], t)
        else:
            slot_cache[name].copy_(t)


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
    return _ffn(p, cfg, x, act)[0]


def _cross_attention(p, x, enc_out, cfg, act):
    """Non-causal cross attention; k/v from the encoder output (no rope)."""
    B, S, _ = x.shape
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    Se = enc_out.shape[1]
    q = attn_lib.split_heads(x @ p["wq"].to(act), H, hd)
    k = attn_lib.split_heads(enc_out @ p["wk"].to(act), G, hd)
    v = attn_lib.split_heads(enc_out @ p["wv"].to(act), G, hd)
    qp = torch.arange(S, device=x.device).expand(B, S)
    kp = torch.arange(Se, device=x.device).expand(B, Se)
    out = attn_lib._sdpa_chunked(q, k, v, qp, kp, causal=False, window=0,
                                 q_chunk=cfg.blockwise_q, kv_chunk=cfg.blockwise_kv)
    return attn_lib.merge_heads(out) @ p["wo"].to(act), (k, v)


def _cross_decode(p, x, ck, cv, cfg, act):
    B = x.shape[0]
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rep = H // G
    kf = ck.float().repeat_interleave(rep, dim=2)
    vf = cv.float().repeat_interleave(rep, dim=2)
    q = attn_lib.split_heads(x @ p["wq"].to(act), H, hd).reshape(B, H, hd)
    s = torch.einsum("bhd,bkhd->bhk", q.float() / attn_lib.sqrt_f32(hd), kf)
    out = torch.einsum("bhk,bkhd->bhd", torch.softmax(s, dim=-1), vf)
    return out.reshape(B, 1, H * hd).to(act) @ p["wo"].to(act)


# ---------------------------------------------------------------------------
# stack runner
# ---------------------------------------------------------------------------

def _units(tree, n: int) -> list:
    """The ``n`` units of a stacked tree: every leaf unbound once along its
    leading axis, so each unit's leaves are views of the stack and autograd
    stacks their gradients back into one tensor a leaf."""
    if isinstance(tree, dict):
        per = {k: _units(v, n) for k, v in tree.items()}
        return [{k: per[k][u] for k in tree} for u in range(n)]
    return tree.unbind(0)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: save the outputs of the plain matrix products
    (``aten.mm``: ``x @ W`` on any batch of rows), recompute the rest,
    batched products (``bmm``: attention, the SSD, the experts) included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn):
    """``fn`` under ``cfg.remat`` while autograd records (see the module's
    docstring); as it is otherwise."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, fn, **kw)


def _train_unit(cfg, pattern, positions, enc_out, x, aux, up):
    """One unit of the ``train`` mode: its slots in order, no cache; the
    MoE losses added to ``aux`` in the reference's order."""
    x = _lc(x, "batch", None, None)
    for si, kind in enumerate(pattern):
        x, a = _block_full(up[f"s{si}"], cfg, kind, x, positions, enc_out, None)
        if a is not None:
            aux = aux + a
    return x, aux


def _run_segments(params, cfg, x, positions, cache, enc_out, mode):
    """mode: 'train' | 'prefill' | 'decode'. Returns ``(x, cache, aux)``: in
    the ``train`` mode no cache (``cache`` is not read) and ``aux`` the MoE
    load-balance losses summed in float32; in the serving modes the cache
    written and no ``aux`` (their callers drop it)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    if mode == "train":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for gi, (pattern, n_units) in enumerate(segments_of(cfg)):
            body = _remat(cfg, functools.partial(_train_unit, cfg, pattern, positions, enc_out))
            for up in _units(params["segments"][gi], n_units):
                x, aux = body(x, aux, up)
        return x, None, aux
    act = _act_dtype(cfg)
    segments = []
    for gi, (pattern, n_units) in enumerate(segments_of(cfg)):
        seg_cache = cache["segments"][gi]
        if mode == "decode":
            # the reference's blend promotes these leaves to the compute
            # dtype; promoting the stack once lets every unit write its view
            seg_cache = {s: {n: t.to(torch.promote_types(t.dtype, act)) if n in BLENDED else t
                             for n, t in c.items()} for s, c in seg_cache.items()}
        for u, up in enumerate(_units(params["segments"][gi], n_units)):
            if mode != "decode":
                x = _lc(x, "batch", None, None)
            for si, kind in enumerate(pattern):
                sp = up[f"s{si}"]
                sc = {n: t[u] for n, t in seg_cache[f"s{si}"].items()}
                if mode == "decode":
                    x = _block_decode(sp, cfg, kind, x, positions, sc)
                else:
                    x = _block_full(sp, cfg, kind, x, positions, enc_out, sc)[0]
        segments.append(seg_cache)
    return x, {"segments": segments}, None


def _encode(params, cfg, enc_embeds):
    """Whisper-style encoder over precomputed frame embeddings (stub frontend)."""
    act = _act_dtype(cfg)
    x = enc_embeds.to(act)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for p in _units(params["encoder"]["layers"], cfg.enc_layers):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = attn_lib._project_qkv(p["mix"], h, cfg, positions, act)
        out = attn_lib._sdpa_chunked(q, k, v, positions, positions, causal=False, window=0,
                                     q_chunk=cfg.blockwise_q, kv_chunk=cfg.blockwise_kv)
        x = _residual(x, attn_lib.merge_heads(out) @ p["mix"]["wo"].to(act))
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = _residual(x, mlp(p["mlp"], h2, cfg.gated_mlp, act_dtype=act))
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
    out = lm_logits(head, x, act_dtype=_act_dtype(cfg))
    return _lc(out, "batch", *([None] * (out.ndim - 2)), "vocab")


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def loss_fn(params, cfg, batch, aux_coef: float = 0.01):
    """Next-token CE (+ the MoE load-balance aux). Returns ``(loss, {"ce",
    "aux"})``, 0-dim float32 tensors.

    ``batch``: ``tokens`` and ``targets`` (B, S) integer tensors on the
    parameters' device, and an enc-dec model's ``enc_embeds`` or a VLM's
    ``prefix_embeds`` as :func:`prefill` takes them. When ``cfg.loss_chunk``
    divides S and is smaller than S, the CE runs over sequence chunks, each
    chunk's logits inside its own checkpoint (recomputed in the backward
    pass), so the (B, S, V) logits never exist at once.
    """
    tokens, targets = batch["tokens"], batch["targets"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _embed_inputs(params, cfg, tokens, batch)
    enc_out = _encode(params, cfg, batch["enc_embeds"]) if cfg.family == "encdec" else None
    x, _, aux = _run_segments(params, cfg, x, positions, None, enc_out, "train")
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)

    def chunk_ce(xb, tb):
        return cross_entropy(_logits(params, cfg, xb), tb, cfg.vocab_size)

    lc = cfg.loss_chunk
    if lc and S % lc == 0 and S > lc:
        if torch.is_grad_enabled():
            chunk_ce = functools.partial(checkpoint, chunk_ce, use_reentrant=False,
                                         preserve_rng_state=False)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, S, lc):
            total = total + chunk_ce(x[:, c:c + lc], targets[:, c:c + lc])
        ce = total / (S // lc)
    else:
        ce = chunk_ce(x, targets)
    return ce + aux_coef * aux, {"ce": ce, "aux": aux}


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
    if is_distributed(tokens):  # the cache placed as the reference's rules place it
        cache = cache_shardings(cfg, cache_specs(cfg, B, max_seq or S), tokens.device_mesh,
                                tokens.to_local().device)
    else:
        cache = init_cache(cfg, batch=B, max_seq=max_seq or S, device=tokens.device)
    x = _embed_inputs(params, cfg, tokens, batch)
    enc_out = _encode(params, cfg, batch["enc_embeds"]) if cfg.family == "encdec" else None
    x, cache, _ = _run_segments(params, cfg, x, positions, cache, enc_out, "prefill")
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache


def decode_step(params, cfg, tokens, positions, cache):
    """One AR step for a batch. tokens: (B,1); positions: (B,). The new
    entries go into ``cache`` in place; returns (logits, cache)."""
    x = embed(params["embed"], tokens, act_dtype=_act_dtype(cfg))
    x, cache, _ = _run_segments(params, cfg, x, positions, cache, None, "decode")
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache
