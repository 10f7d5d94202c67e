"""Mamba-2 (SSD, state-space duality) block.

The reference's (``repro.models.ssm``). Chunked SSD: the sequence is split
into chunks of ``ssm_chunk``; inside a chunk the interactions are a masked,
decay-weighted quadratic form (the exponent clamped at -60 above the
diagonal before ``exp``), and across chunks a (B, nh, P, N) state is carried
by a Python loop over the chunks (the reference's ``lax.scan``). State and
products run in float32. A sequence whose length is not a multiple of
``min(ssm_chunk, S)`` raises ``ValueError``, where the reference asserts:
padding it would change the state carried out of it.

Single-token decode is the O(1) recurrence on the state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..tree import is_distributed
from . import sharding
from .layers import dense_init, rmsnorm
from .sharding import logical_constraint as _lc
from .sharding import model_axis_size


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_ssm(generator, cfg, dtype, device, lead=()):
    D = cfg.d_model
    d_in = cfg.ssm_expand * D
    N = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((*lead, cfg.ssm_conv, conv_dim), generator=generator, **f32)
    return {
        "in_proj": dense_init(generator, D, 2 * d_in + 2 * N + nh, dtype, device, lead=lead),
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)).expand(*lead, nh).clone(),
        "D": torch.ones((*lead, nh), **f32),
        "dt_bias": torch.zeros((*lead, nh), **f32),
        "norm_scale": torch.ones((*lead, d_in), dtype=dtype, device=device),
        "out_proj": dense_init(generator, d_in, D, dtype, device, lead=lead),
    }


def _split_proj(params, x, cfg, act_dtype):
    d_in = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    zxbcdt = x @ params["in_proj"].to(act_dtype)
    z = _lc(zxbcdt[..., :d_in], "batch", None, "ffn")
    return z, zxbcdt[..., d_in:2 * d_in + 2 * N], zxbcdt[..., -nh:], d_in, N, nh


def causal_conv(xbc, w, b, conv_state=None):
    """Depthwise causal conv of width K, without its activation.
    xbc: (B,S,C); w: (K,C); conv_state: the (B,K-1,C) tail of the previous
    call. Returns (out, new tail), in ``xbc``'s dtype."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    out = xp[:, 0:S] * w[0].to(xbc.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i].to(xbc.dtype)
    return out + b.to(xbc.dtype), xp[:, -(K - 1):]


def ssd_chunked(xh, dt, A, Bm, Cm, chunk, init_state=None):
    """Chunked SSD core.

    xh: (B,S,nh,P) inputs; dt: (B,S,nh) softplus'd step; A: (nh,) < 0;
    Bm/Cm: (B,S,N) shared across heads (n_groups=1).
    Returns (y: (B,S,nh,P) float32, final_state: (B,nh,P,N) float32).
    DTensor operands run on each rank's shards (``sharding.on_shards``):
    the batch on the batch axes, the heads on the model axis where they
    divide it, as the state's cache rule places them.
    """
    if not is_distributed(xh):
        return _ssd_local(xh, dt, A, Bm, Cm, chunk, init_state)
    mesh = xh.device_mesh
    Bsz, _, nh, P = xh.shape
    heads = "heads" if nh % sharding.mesh_sizes(mesh).get("model", 1) == 0 else None
    state = ("batch", heads, None, None)
    return sharding.on_shards(
        lambda *a: _ssd_local(*a[:5], chunk, a[5]), (xh, dt, A, Bm, Cm, init_state),
        (("batch", None, heads, None), ("batch", None, heads), (heads,),
         ("batch", None, None), ("batch", None, None), state),
        [sharding.role_placements(("batch", None, heads, None), xh.shape, mesh),
         sharding.role_placements(state, (Bsz, nh, P, Bm.shape[-1]), mesh)])


def _ssd_local(xh, dt, A, Bm, Cm, chunk, init_state=None):
    """:func:`ssd_chunked` of plain tensors."""
    Bsz, S, nh, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"SSD: a sequence of {S} tokens is not a multiple of the "
                         f"chunk {Q} (ssm_chunk {chunk}); use a length below the "
                         "chunk or a multiple of it")
    nc = S // Q
    f32 = torch.float32

    la = (dt * A[None, None, :]).reshape(Bsz, nc, Q, nh)          # log a_t (<0)
    xc = xh.reshape(Bsz, nc, Q, nh, P).to(f32)
    dtc = dt.reshape(Bsz, nc, Q, nh)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(f32)

    cum = torch.cumsum(la, dim=2)                                  # L_t within chunk
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # (B,nc,Q_t,Q_s,nh)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()[None, None, :, :, None]
    # clamp before exp: above the diagonal the exponent is positive
    seg = torch.where(causal, seg, -60.0)
    decay = torch.exp(seg) * causal

    # intra-chunk: y[t] = sum_s C_t.B_s decay(t,s) dt_s x_s
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
    m = cb[..., None] * decay * dtc[:, :, None, :, :]              # (B,nc,t,s,nh)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", m, xc)

    # per-chunk aggregated state contribution: sum_s exp(L_Q - L_s) dt_s B_s x_s
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc                # (B,nc,Q,nh)
    sc = torch.einsum("bcsh,bcsn,bcshp->bchpn", tail, Bc, xc)

    # inter-chunk recurrence of the (nh,P,N) state
    chunk_decay = torch.exp(cum[:, :, -1, :])                      # (B,nc,nh)
    state = torch.zeros((Bsz, nh, P, N), dtype=f32, device=xh.device) \
        if init_state is None else init_state.to(f32)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + sc[:, c]
    prev_states = torch.stack(prevs, dim=1)                        # (B,nc,nh,P,N)

    # inter-chunk output: C_t exp(L_t) S_prev
    y_inter = torch.einsum("bctn,bchpn,bcth->bcthp", Cc, prev_states, torch.exp(cum))
    return (y_intra + y_inter).reshape(Bsz, S, nh, P), state


def ssm_forward(params, x, cfg, conv_state=None, ssd_state=None, act_dtype=torch.bfloat16):
    """Full-sequence Mamba-2 block. Returns (out, (conv_state, ssd_state))."""
    B, S, D = x.shape
    z, xbc, dt, d_in, N, nh = _split_proj(params, x, cfg, act_dtype)
    P = cfg.ssm_head_dim

    xbc, new_conv = causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xh = xbc[..., :d_in].reshape(B, S, nh, P)
    Bm = xbc[..., d_in:d_in + N]
    Cm = xbc[..., d_in + N:]

    dt = softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, new_state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, ssd_state)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in).to(act_dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    return y @ params["out_proj"].to(act_dtype), (new_conv, new_state)


def ssm_decode(params, x, cfg, conv_state, ssd_state, act_dtype=torch.bfloat16):
    """O(1) single-token step. x: (B,1,D). Returns (out, (conv_state, ssd_state))."""
    B = x.shape[0]
    z, xbc, dt, d_in, N, nh = _split_proj(params, x, cfg, act_dtype)
    P = cfg.ssm_head_dim

    xbc, new_conv = causal_conv(xbc, params["conv_w"], params["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xh = xbc[:, 0, :d_in].reshape(B, nh, P)
    Bm = xbc[:, 0, d_in:d_in + N]
    Cm = xbc[:, 0, d_in + N:]

    dt = softplus(dt[:, 0].float() + params["dt_bias"])                  # (B,nh)
    tp = model_axis_size()
    if tp and nh % tp:
        # heads that do not divide a model axis stay whole, as the state's
        # cache rule keeps them: DTensor cannot flatten unevenly sharded heads
        dt = _lc(dt, "batch", None)
    a = torch.exp(dt * (-torch.exp(params["A_log"]))[None, :])            # (B,nh)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), xh.float())
    new_state = ssd_state.float() * a[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), new_state)
    y = y + params["D"][None, :, None] * xh.float()
    y = y.reshape(B, 1, d_in).to(act_dtype)
    y = y * F.silu(z)
    y = rmsnorm({"scale": params["norm_scale"]}, y, cfg.norm_eps)
    return y @ params["out_proj"].to(act_dtype), (new_conv, new_state)
