"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The reference's (``repro.models.rglru``). Recurrence: h_t = a_t * h_{t-1} +
sqrt(1 - a_t^2) * (i_t * x_t), with a_t = exp(-c * softplus(Lambda) *
sigmoid(W_r x_t)), c = 8. The block: x -> [gelu gate branch | conv1d ->
RG-LRU branch] -> elementwise merge -> out projection.

The reference's prefill runs ``jax.lax.associative_scan``; PyTorch has no
public one, and a loop over the tokens is slow, so the port runs the same
linear recurrence in chunks of :data:`SCAN_CHUNK` tokens: inside a chunk
h_t = sum_{s <= t} exp(L_t - L_s) x_s + exp(L_t) h_in, with L the
cumulative sum of log a_t over the chunk (a causal decay matrix), and the
chunk's last h carried into the next. exp(L_t - L_s) rounds where the scan
multiplies: at 1,024 tokens in float32 the block's output and final h stay
within rel 4e-7 of the reference's, and the chunked scan within rel 5e-7
of a float64 loop (``tests/test_torch_lm_rglru.py``). Its gradient is the
scan's adjoint, the same chunked scan run backwards in time. Decode is the
O(1) update on a (B, d_rnn) state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..tree import is_distributed
from . import sharding
from .layers import dense_init
from .sharding import logical_constraint as _lc
from .ssm import causal_conv, softplus

_C = 8.0  # Griffin's recurrence sharpness constant
SCAN_CHUNK = 64


def init_rglru(generator, cfg, dtype, device, lead=()):
    D = cfg.d_model
    R = cfg.rnn_width or D
    conv_w = torch.randn((*lead, cfg.ssm_conv, R), generator=generator,
                         dtype=torch.float32, device=device)
    return {
        "w_gate": dense_init(generator, D, R, dtype, device, lead=lead),
        "w_rec_in": dense_init(generator, D, R, dtype, device, lead=lead),
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": torch.zeros((*lead, R), dtype=dtype, device=device),
        "w_r": dense_init(generator, R, R, dtype, device, scale=0.02, lead=lead),
        "w_i": dense_init(generator, R, R, dtype, device, scale=0.02, lead=lead),
        "lam": torch.full((*lead, R), 2.0, dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, R, D, dtype, device, lead=lead),
    }


def _gates(params, u):
    """log a_t (<= 0) and the scaled input of the recurrence, float32."""
    r = torch.sigmoid((u @ params["w_r"].to(u.dtype)).float())
    i = torch.sigmoid((u @ params["w_i"].to(u.dtype)).float())
    log_a = -_C * softplus(params["lam"]) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * i * u.float()


def _chunked_scan(log_a, x, chunk):
    """h_t = exp(log_a_t) h_{t-1} + x_t from h_{-1} = 0, chunk by chunk."""
    B, S, R = x.shape
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    h_in = torch.zeros((B, R), dtype=torch.float32, device=x.device)
    out = []
    for c0 in range(0, S, chunk):
        L = torch.cumsum(log_a[:, c0:c0 + chunk], dim=1)               # (B,q,R)
        q = L.shape[1]
        seg = L[:, :, None, :] - L[:, None, :, :]                       # (B,q_t,q_s,R)
        decay = torch.exp(torch.where(causal[:, :q, :q], seg, -torch.inf))
        h = torch.einsum("btsr,bsr->btr", decay, x[:, c0:c0 + chunk]) \
            + torch.exp(L) * h_in[:, None, :]
        out.append(h)
        h_in = h[:, -1]
    return torch.cat(out, dim=1)


class _LinearScan(torch.autograd.Function):
    """The chunked scan with its exact adjoint: g_t = dh_t + a_{t+1} g_{t+1}
    (the same scan run backwards in time), dx_t = g_t and dlog_a_t = g_t
    h_{t-1} a_t. Differentiating the chunked form itself would take log a's
    gradient as differences of the cumulative sums' (rel ~1e-3 of its scale
    at 200 tokens in float32, against ~5e-7 this way); only h and log a are
    saved."""

    @staticmethod
    def forward(ctx, log_a, x, chunk):
        h = _chunked_scan(log_a, x, chunk)
        ctx.save_for_backward(log_a, h)
        ctx.chunk = chunk
        return h

    @staticmethod
    def backward(ctx, dh):
        log_a, h = ctx.saved_tensors
        zero = torch.zeros_like(log_a[:, :1])
        # reversed in time, step k decays by a_{S-k}: log_a shifted by one
        decay = torch.cat([log_a[:, 1:], zero], dim=1).flip(1)
        g = _chunked_scan(decay, dh.float().flip(1), ctx.chunk).flip(1)
        h_prev = torch.cat([zero, h[:, :-1]], dim=1)
        return g * h_prev * torch.exp(log_a), g, None


def linear_scan(log_a, x, chunk=SCAN_CHUNK):
    """h_t = exp(log_a_t) h_{t-1} + x_t from h_{-1} = 0, along axis 1 of
    (B, S, R) float32 tensors, in chunks of ``chunk`` tokens; differentiable
    (its adjoint is the reverse scan, :class:`_LinearScan`). DTensor
    operands run on each rank's shards (``sharding.on_shards``): the batch
    on the batch axes, R on the model axis where it divides it."""
    if not is_distributed(x):
        return _LinearScan.apply(log_a, x, chunk)
    roles = ("batch", None, "ffn")
    return sharding.on_shards(lambda a, b: _LinearScan.apply(a, b, chunk), (log_a, x),
                              (roles, roles), sharding.role_placements(roles, x.shape,
                                                                       x.device_mesh))


def rglru_forward(params, x, cfg, conv_state=None, h_state=None, act_dtype=torch.bfloat16):
    """Full-sequence Griffin recurrent block. Returns (out, (conv_state, h))."""
    gate = _lc(F.gelu(x @ params["w_gate"].to(act_dtype), approximate="tanh"),
               "batch", None, "ffn")
    u = _lc(x @ params["w_rec_in"].to(act_dtype), "batch", None, "ffn")
    u, new_conv = causal_conv(u, params["conv_w"], params["conv_b"], conv_state)

    log_a, x_in = _gates(params, u)
    if h_state is not None:
        # fold the carried state into step 0's input, as the reference
        x_in = x_in.clone()
        x_in[:, 0] += torch.exp(log_a[:, 0]) * h_state.float()
    h = linear_scan(log_a, x_in)
    y = (gate * h.to(act_dtype)) @ params["out_proj"].to(act_dtype)
    return y, (new_conv, h[:, -1])


def rglru_decode(params, x, cfg, conv_state, h_state, act_dtype=torch.bfloat16):
    """O(1) single-token step. x: (B,1,D). Returns (out, (conv_state, h))."""
    gate = F.gelu(x @ params["w_gate"].to(act_dtype), approximate="tanh")
    u = x @ params["w_rec_in"].to(act_dtype)
    u, new_conv = causal_conv(u, params["conv_w"], params["conv_b"], conv_state)
    log_a, x_in = _gates(params, u[:, 0])
    h = torch.exp(log_a) * h_state.float() + x_in
    y = (gate[:, 0] * h.to(act_dtype)) @ params["out_proj"].to(act_dtype)
    return y[:, None], (new_conv, h)
