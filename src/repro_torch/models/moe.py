"""Mixture-of-Experts layer: top-k routing with expert capacity, shared
experts (DeepSeek) and a parallel dense residual FFN (Arctic).

The reference's function (``repro.models.moe``), computed another way.
Tokens are routed in groups of ``g = min(moe_group_size, S)`` along the
sequence when g divides S, else in one group of S; each expert takes
``C = max(k, round_up_4(int(g * k / E * factor) + 1))`` tokens of a group.
Routing probabilities are the float32 softmax of the compute-dtype router
product; the top k (the lower expert first on a tie, as ``jax.lax.top_k``)
are renormalized (their sum clamped at 1e-9). Queue positions are
choice-major: every token's first choice in a group precedes any second
choice, and a (token, choice) whose position reaches C is dropped.

Where the reference builds one-hot (B, n, T, E, C) dispatch and combine
tensors, the port scatters each kept (token, choice) into an (E, B*n,
C + 1, D) buffer at (expert, group, position) (the dropped ones into the
spare position C, which nothing reads), runs the experts that hold a token
as batched products, and gathers each token's k rows back, weighted by its
gates cast to the compute dtype and summed in float32. An expert that holds
no token adds exact zeros in the reference, so skipping it is the same
function; a decode step then reads the weights of at most B*k experts.
``moe_combine_f32`` gives the same values: the reference casts its float32
combine tensor to the compute dtype before the combine.

On DTensor operands (a mesh set by ``sharding.set_mesh``) the layer takes
the reference's form instead (:func:`_experts_onehot`): the (B, n, T, E, C)
one-hot ``combine`` and ``dispatch`` tensors, the einsum into the expert
buffers, the three expert products over all E experts and the einsum back
to tokens, constrained at the reference's four sites. DTensor has no
indexed write into a sharded buffer, and the held experts' ids would be a
host fetch, which meta shards cannot answer. The routing is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..tree import is_distributed
from . import sharding
from .layers import dense_init
from .sharding import logical_constraint as _lc


def init_moe(generator, cfg, dtype, device, lead=()):
    D = cfg.d_model
    E, Fe = cfg.moe_num_experts, cfg.moe_d_ff

    def ffn(d_ff, lead):
        return {"wi": dense_init(generator, D, d_ff, dtype, device, lead=lead),
                "wg": dense_init(generator, D, d_ff, dtype, device, lead=lead),
                "wo": dense_init(generator, d_ff, D, dtype, device, lead=lead)}

    p = {"router": dense_init(generator, D, E, dtype, device, scale=0.02, lead=lead),
         **ffn(Fe, (*lead, E))}
    if cfg.moe_num_shared:
        p["shared"] = ffn(cfg.moe_num_shared * Fe, lead)
    if cfg.moe_dense_ff:
        p["dense"] = ffn(cfg.moe_dense_ff, lead)
    return p


def _capacity(group: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(group * top_k / n_experts * factor) + 1
    return max(top_k, (c + 3) // 4 * 4)


def _groups(cfg, S: int) -> tuple:
    """``(n_groups, group_size)`` along a sequence of S tokens."""
    g = min(cfg.moe_group_size, S)
    return (S // g, g) if S % g == 0 else (1, S)


class Routing(NamedTuple):
    """One MoE call's routing, tokens grouped as (B * n_groups, g)."""
    probs: torch.Tensor    # (BN, g, E) float32
    top_i: torch.Tensor    # (BN, g, k) expert of each choice
    top_p: torch.Tensor    # (BN, g, k) renormalized float32 gate
    pos: torch.Tensor      # (BN, g, k) position in the expert's queue
    capacity: int

    @property
    def fits(self) -> torch.Tensor:
        return self.pos < self.capacity


def route(params, xg, cfg, act_dtype) -> Routing:
    """Top-k routing of ``xg`` (BN, g, D) with choice-major queue positions."""
    BN, g, _ = xg.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    logits = (xg @ params["router"].to(act_dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: on a tie the lower expert first, as lax.top_k
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    # position of each (token, choice) in its expert's queue, choice-major
    cm = top_i.transpose(1, 2).reshape(BN, k * g)                  # (BN, k*g)
    oh = F.one_hot(cm, E).to(torch.int32)
    pos = (oh.cumsum(dim=1) - 1).gather(2, cm[..., None])[..., 0]
    pos = pos.reshape(BN, k, g).transpose(1, 2)                      # (BN, g, k)
    return Routing(probs, top_i, top_p, pos, _capacity(g, k, E, cfg.moe_capacity_factor))


def _swiglu(p, x, act_dtype):
    h = x @ p["wi"].to(act_dtype)
    g = x @ p["wg"].to(act_dtype)
    return (F.silu(g) * h) @ p["wo"].to(act_dtype)


def _experts_scatter(params, xg, r: Routing, act_dtype):
    """The kept (token, choice) rows through the experts that hold one, as
    (BN, g, D) in ``act_dtype``: a scatter into expert buffers, batched
    products, a gather back, each token's k rows summed in float32."""
    BN, g, D = xg.shape
    E, k = params["wi"].shape[0], r.top_i.shape[-1]
    C = r.capacity
    fits = r.fits
    slot = torch.clamp_max(r.pos, C)                                 # drops -> spare slot C
    grp = torch.arange(BN, device=xg.device)[:, None, None].expand(BN, g, k)

    buf = torch.zeros((E, BN, C + 1, D), dtype=act_dtype, device=xg.device)
    buf[r.top_i, grp, slot] = xg[:, :, None, :].expand(BN, g, k, D)
    # the experts that hold a kept token (a host fetch of their ids)
    held = torch.zeros(E, dtype=torch.int32, device=xg.device)
    held.index_put_((r.top_i,), fits.to(torch.int32), accumulate=True)
    occ = held.nonzero()[:, 0]
    n_occ = occ.numel()
    if n_occ == E:
        xo, w = buf, {n: params[n] for n in ("wi", "wg", "wo")}
    else:
        xo, w = buf[occ], {n: params[n][occ] for n in ("wi", "wg", "wo")}
    xo = xo.reshape(n_occ, BN * (C + 1), D)
    h = torch.bmm(xo, w["wi"].to(act_dtype))
    gt = torch.bmm(xo, w["wg"].to(act_dtype))
    ye = torch.bmm(F.silu(gt) * h, w["wo"].to(act_dtype)).reshape(n_occ, BN, C + 1, D)
    del buf, xo, h, gt, w

    # tokens <- expert buffers: each kept choice's row, gated, summed in float32
    index = torch.zeros(E, dtype=torch.long, device=xg.device)   # expert -> its row in ye
    index[occ] = torch.arange(n_occ, device=xg.device)
    rows = ye[index[r.top_i], grp, slot].float()                     # (BN, g, k, D)
    gate = (r.top_p * fits).to(act_dtype).float()
    return (gate[..., None] * rows).sum(dim=2).to(act_dtype)


def _experts_onehot(params, xg, r: Routing, cfg, B: int, act_dtype):
    """The reference's dispatch and combine (``repro.models.moe``): the
    (B, n, T, E, C) one-hot tensors, built in ``act_dtype`` (float32 for
    ``moe_combine_f32``), every expert's products, and the einsum back to
    tokens, constrained at the reference's four sites. The three
    contractions run on each rank's shards (``sharding.on_shards``): the
    expert buffers on the experts' model axis, the combine a partial sum
    over it. Returns (BN, g, D)."""
    from torch.distributed.tensor import Partial, Shard

    BN, g, D = xg.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    C = r.capacity
    lead = (B, BN // B, g)
    top_i, pos = r.top_i.reshape(*lead, k), r.pos.reshape(*lead, k)
    cdt = torch.float32 if cfg.moe_combine_f32 else act_dtype
    gate = (r.top_p * r.fits).reshape(*lead, k).to(cdt)
    experts = torch.arange(E, device=xg.device)
    slots = torch.arange(C, device=xg.device)
    combine = None
    for j in range(k):  # a position past C matches no slot: the drop
        sel = ((top_i[..., j, None] == experts).to(cdt)[..., :, None]
               * (pos[..., j, None] == slots).to(cdt)[..., None, :])
        term = gate[..., j, None, None] * sel
        combine = term if combine is None else combine + term
    onehot = ("batch", None, None, "expert", None)
    combine = _lc(combine, *onehot)
    dispatch = _lc((combine > 0).to(act_dtype), *onehot)

    # tokens -> expert buffers -> tokens
    mesh = xg.device_mesh
    buf = ("batch", None, "expert", None, None)
    buf_at = sharding.role_placements(buf, (*lead[:2], E, C, D), mesh)
    xe = sharding.on_shards(
        lambda d, x: torch.einsum("bntec,bntd->bnecd", d, x),
        (dispatch, xg.reshape(*lead, D)), (onehot, ("batch", None, None, None)), buf_at)
    xe = _lc(xe, *buf)
    ye = sharding.on_shards(
        _expert_products, (xe, *(params[n].to(act_dtype) for n in ("wi", "wg", "wo"))),
        (buf, *([("expert", None, None)] * 3)), buf_at)
    ye = _lc(ye, *buf)
    model = mesh.mesh_dim_names.index("model")
    out_at = list(sharding.role_placements(("batch", None, None, None), (*lead, D), mesh))
    if isinstance(buf_at[model], Shard):  # each rank sums its own experts' rows
        out_at[model] = Partial()
    out = sharding.on_shards(
        lambda c, y: torch.einsum("bntec,bnecd->bntd", c, y),
        (combine.to(act_dtype), ye), (onehot, buf), tuple(out_at))
    return out.reshape(BN, g, D)


def _expert_products(xe, wi, wg, wo):
    """Each expert's SwiGLU of its (B, n, C) buffer rows: one batched
    product over the experts, (B, n, E, C, D) in and out."""
    B, n, E, C, D = xe.shape
    xo = xe.permute(2, 0, 1, 3, 4).reshape(E, B * n * C, D)
    h = torch.bmm(xo, wi)
    gt = torch.bmm(xo, wg)
    ye = torch.bmm(F.silu(gt) * h, wo)
    return ye.reshape(E, B, n, C, D).permute(1, 2, 0, 3, 4)


def moe_forward(params, x, cfg, act_dtype=torch.bfloat16):
    """x: (B, S, D) -> (out, aux_loss)."""
    B, S, D = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    n_g, g = _groups(cfg, S)
    xg = x.reshape(B * n_g, g, D).to(act_dtype)
    r = route(params, xg, cfg, act_dtype)
    if is_distributed(x):
        out = _experts_onehot(params, xg, r, cfg, B, act_dtype)
    else:
        out = _experts_scatter(params, xg, r, act_dtype)
    out = out.reshape(B, S, D)

    # load-balancing auxiliary loss (Switch-style)
    frac_tokens = F.one_hot(r.top_i, E).float().sum(dim=2).div(k).mean(dim=(0, 1))
    frac_probs = r.probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)

    # shared experts / dense residual run on all tokens
    if "shared" in params:
        out = out + _swiglu(params["shared"], x, act_dtype)
    if "dense" in params:
        out = out + _swiglu(params["dense"], x, act_dtype)
    return out, aux
