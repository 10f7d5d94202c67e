"""Layer-stack assembly: init, prefill, decode.

The stack is decomposed into *segments* of repeating layer-pattern *units*
(see cache.segments_of), as the reference's (``repro.models.transformer``);
a dense model is one segment of a 1-layer pattern. Parameters are the
reference's tree, each segment's slots stacked on a leading ``n_units`` axis,
so ``convert.lm_params_from_jax`` carries the reference's weights across as
they are; the port runs the units in a Python loop over views of that axis.

The port runs the ``attn`` slot kind of the ``dense`` family, in the
``prefill`` and ``decode`` modes. The other kinds (mla, ssm, rec), cross
attention and the encoder raise ``NotImplementedError`` (ROADMAP item 16b);
``loss_fn`` and the ``train`` mode wait for item 16c.

The K/V cache is written in place: ``prefill`` fills a new cache, and
``decode_step`` writes each unit's new K/V into the cache it is given and
returns it, at the dtype the reference's one-hot blend gives (a float32
model's bf16 cache comes back float32).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import resolve_device
from . import attention as attn_lib
from .cache import init_cache, segments_of
from .config import require_ported
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


def _act_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _require_attn(kind):
    if kind != "attn":
        raise NotImplementedError(f"the {kind!r} block is not ported yet (ROADMAP item 16b)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_slot(generator, cfg, kind, dtype, device, lead):
    p = {"ln1": init_rmsnorm(cfg.d_model, dtype, device, lead),
         "mix": attn_lib.init_attention(generator, cfg, dtype, device, lead),
         "ln2": init_rmsnorm(cfg.d_model, dtype, device, lead)}
    if cfg.d_ff:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device,
                            cfg.gated_mlp, lead)
    return p


def _init_tree(cfg, generator, device):
    require_ported(cfg)
    dtype = torch.float32 if cfg.param_dtype == "float32" else torch.bfloat16
    params = {"embed": init_embed(generator, cfg.padded_vocab, cfg.d_model, dtype, device)}
    params["segments"] = [
        {f"s{si}": _init_slot(generator, cfg, kind, dtype, device, (n_units,))
         for si, kind in enumerate(pattern)}
        for pattern, n_units in segments_of(cfg)]
    params["final_norm"] = init_rmsnorm(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, cfg.d_model, cfg.padded_vocab, dtype, device)
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
    compute dtype (``cfg.dtype``); the norm scales stay as they are, since
    ``rmsnorm`` reads them in float32. Each product's ``.to(act_dtype)`` is
    then a no-op, and the values are those of casting each call."""
    act = _act_dtype(cfg)

    def cast(tree):
        if isinstance(tree, dict):
            return {k: v if k == "scale" else cast(v) for k, v in tree.items()}
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

def _block_full(p, cfg, kind, x, positions, slot_cache):
    """Full-sequence block (prefill); writes the slot's K/V into
    ``slot_cache``. Returns x."""
    _require_attn(kind)
    act = _act_dtype(cfg)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    out, (k, v) = attn_lib.attention_forward(p["mix"], h, cfg, positions, act_dtype=act)
    W = slot_cache["k"].shape[1]
    S = k.shape[1]
    for name, new in (("k", k), ("v", v)):
        if S >= W:
            # ring semantics: decode writes slot = pos % W, so the last W
            # keys must land at slots (S-W+i) % W, i.e. roll by S % W
            new = torch.roll(new[:, -W:], S % W, dims=1)
        else:   # cache larger than prompt: fill the head, zero-pad
            new = attn_lib._pad_axis(new, W, 1)
        slot_cache[name].copy_(new)
    x = x + out
    if "mlp" in p:
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h2, cfg.gated_mlp, act_dtype=act)
    return x


def _block_decode(p, cfg, kind, x, positions, slot_cache):
    """Single-token block; writes the new K/V into ``slot_cache`` in place
    (its dtype already the promoted one, see ``_run_segments``). Returns x."""
    _require_attn(kind)
    act = _act_dtype(cfg)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    W = slot_cache["k"].shape[1]
    cache_pos = positions % W if cfg.attn_window else positions
    out, _, _ = attn_lib.attention_decode(p["mix"], h, cfg, positions, slot_cache["k"],
                                          slot_cache["v"], cache_pos, act_dtype=act)
    x = x + out
    if "mlp" in p:
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], h2, cfg.gated_mlp, act_dtype=act)
    return x


# ---------------------------------------------------------------------------
# stack runner
# ---------------------------------------------------------------------------

def _run_segments(params, cfg, x, positions, cache, mode):
    """mode: 'prefill' | 'decode'. Returns (x, cache)."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mode {mode!r} is not ported yet (ROADMAP item 16c)")
    act = _act_dtype(cfg)
    segments = []
    for gi, (pattern, n_units) in enumerate(segments_of(cfg)):
        seg_params = params["segments"][gi]
        seg_cache = cache["segments"][gi]
        if mode == "decode":
            # the reference's blend promotes the cache to the compute dtype;
            # promoting the stack once lets every unit write into its view
            seg_cache = {s: {n: t.to(torch.promote_types(t.dtype, act)) for n, t in c.items()}
                         for s, c in seg_cache.items()}
        for u in range(n_units):
            for si, kind in enumerate(pattern):
                sp = _map(lambda t: t[u], seg_params[f"s{si}"])
                sc = {n: t[u] for n, t in seg_cache[f"s{si}"].items()}
                if mode == "decode":
                    x = _block_decode(sp, cfg, kind, x, positions, sc)
                else:
                    x = _block_full(sp, cfg, kind, x, positions, sc)
        segments.append(seg_cache)
    return x, {"segments": segments}


def _embed_inputs(params, cfg, tokens):
    return embed(params["embed"], tokens, act_dtype=_act_dtype(cfg))


def _logits(params, cfg, x):
    head = params["head"] if "head" in params else params["embed"]["tok"].T
    return lm_logits(head, x, act_dtype=_act_dtype(cfg))


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def prefill(params, cfg, batch, max_seq: Optional[int] = None):
    """Process a full prompt; returns (last-token logits, cache).

    ``batch["tokens"]``: (B, S) integer tensor on the parameters' device.
    The cache holds ``max_seq`` (default S) positions.
    """
    require_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    cache = init_cache(cfg, batch=B, max_seq=max_seq or S, device=tokens.device)
    x = _embed_inputs(params, cfg, tokens)
    x, cache = _run_segments(params, cfg, x, positions, cache, "prefill")
    x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache


def decode_step(params, cfg, tokens, positions, cache):
    """One AR step for a batch. tokens: (B,1); positions: (B,). The new K/V
    go into ``cache`` in place; returns (logits, cache)."""
    require_ported(cfg)
    x = embed(params["embed"], tokens, act_dtype=_act_dtype(cfg))
    x, cache = _run_segments(params, cfg, x, positions, cache, "decode")
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache
