"""The LM scaffold's layers and attention (``repro_torch.models.layers``,
``.attention``) against the reference's on the same numpy-seeded inputs.

Tolerances, as max |port - reference| / max |reference| of each output:

* float32: rel 1e-6 for rmsnorm, RoPE and the gated MLP (the same float32
  steps; sums of at most 128 terms in another order), rel 1e-5 for
  attention (float32 scores, softmax and PV over chunks);
* bf16 outputs rounded once from float32 (rmsnorm, RoPE): one bf16 unit in
  the last place of the largest value, 2**-7;
* the bf16 gated MLP: rel 3e-2. Both packages round every product to bf16,
  and the reference's SiLU, lowered by XLA on the CPU as 1/(1 + exp(-x)),
  rounds each of its four steps to bf16 (up to 5.2e-3 off the exact
  sigmoid, against 2.0e-3 for the port's one rounding): a few bf16 units
  (2**-8 each) of the output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, layers

BF16_ONE_ROUNDING = 2.0 ** -7
BF16_MLP = 3e-2
F32 = 1e-6
F32_ATTN = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(mine, ref) -> float:
    a = mine.detach().float().numpy().astype(np.float64)
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(a: np.ndarray, dtype: str):
    """The same float32 numpy array in both packages, cast to ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.tensor(a).to(td)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16_ONE_ROUNDING)])
def test_rmsnorm(dtype, tol):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 7, 64))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    ref = ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-5)
    mine = layers.rmsnorm({"scale": torch.tensor(scale)}, tx, 1e-5)
    assert mine.dtype == DTYPES[dtype][1]
    assert _rel(mine, ref) <= tol


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16_ONE_ROUNDING)])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_at_random_positions(dtype, tol, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    positions = rng.integers(0, 300, (2, 9)).astype(np.int32)
    jx, tx = _pair(x, dtype)
    ref = ref_layers.apply_rope(jx, jnp.asarray(positions), theta)
    mine = layers.apply_rope(tx, torch.tensor(positions), theta)
    assert _rel(mine, ref) <= tol
    # rotate-half over the two contiguous halves: position 0 is the identity
    zero = layers.apply_rope(tx, torch.zeros((2, 9), dtype=torch.int64), theta)
    assert torch.equal(zero, tx)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16_MLP)])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(dtype, tol, gated):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    ref_params = ref_layers.init_mlp(jax.random.PRNGKey(0), 64, 128, jnp.float32, gated)
    params = {k: torch.tensor(np.asarray(v)) for k, v in ref_params.items()}
    jd, td = DTYPES[dtype]
    jx, tx = _pair(x, dtype)
    ref = ref_layers.mlp(ref_params, jx, gated, act_dtype=jd)
    mine = layers.mlp(params, tx, gated, act_dtype=td)
    assert mine.dtype == td
    assert _rel(mine, ref) <= tol


def _attention_case(name):
    cfg = get_smoke_config("qwen2.5-3b").replace(dtype="float32")
    return cfg.replace(**{
        "H=G": dict(num_kv_heads=4),
        "H>G": {},
        "window": dict(attn_window=6),
        "chunks": dict(blockwise_q=8, blockwise_kv=8),
        "chunks+window+MQA": dict(blockwise_q=8, blockwise_kv=8, attn_window=6, num_kv_heads=1),
    }[name])


def _attention_params(cfg, seed):
    """The reference's init, with random (not zero) QKV biases."""
    ref_cfg = ref_smoke("qwen2.5-3b").replace(**{
        k: getattr(cfg, k) for k in ("num_kv_heads", "attn_window", "blockwise_q",
                                     "blockwise_kv", "dtype")})
    p = {k: np.asarray(v) for k, v in ref_attn.init_attention(
        jax.random.PRNGKey(seed), ref_cfg, jnp.float32).items()}
    rng = np.random.default_rng(seed)
    for k in ("bq", "bk", "bv"):
        p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return ref_cfg, {k: jnp.asarray(v) for k, v in p.items()}, \
        {k: torch.tensor(v) for k, v in p.items()}


@pytest.mark.parametrize("case", ["H=G", "H>G", "window", "chunks", "chunks+window+MQA"])
def test_attention_forward(case):
    """S = 20: with blockwise 8 that is 3 query and 3 key chunks, 4 padded
    positions in the last of each."""
    cfg = _attention_case(case)
    ref_cfg, jp, tp = _attention_params(cfg, 3)
    rng = np.random.default_rng(4)
    B, S = 2, 20
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    ref_out, (rk, rv) = ref_attn.attention_forward(jp, jnp.asarray(x), ref_cfg,
                                                   jnp.asarray(positions), act_dtype=jnp.float32)
    out, (k, v) = attention.attention_forward(tp, torch.tensor(x), cfg,
                                              torch.tensor(positions).long(),
                                              act_dtype=torch.float32)
    assert _rel(out, ref_out) <= F32_ATTN
    assert _rel(k, rk) <= F32 and _rel(v, rv) <= F32


@pytest.mark.parametrize("case", ["H=G", "H>G", "window", "chunks+window+MQA"])
def test_attention_decode(case):
    """One token against a bf16 cache of W slots (a ring of 6 with a
    window): the float32 model's write promotes the cache in both packages,
    the new K/V land at the slot, and unwritten slots are masked."""
    cfg = _attention_case(case)
    ref_cfg, jp, tp = _attention_params(cfg, 5)
    rng = np.random.default_rng(6)
    B, W = 3, (cfg.attn_window or 24)
    G, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    positions = np.array([3, 11, 17], np.int32)
    cache_pos = positions % W if cfg.attn_window else positions
    kc = rng.standard_normal((B, W, G, hd)).astype(np.float32)
    vc = rng.standard_normal((B, W, G, hd)).astype(np.float32)
    jk, tk = _pair(kc, "bfloat16")
    jv, tv = _pair(vc, "bfloat16")
    ref_out, rk, rv = ref_attn.attention_decode(jp, jnp.asarray(x), ref_cfg, jnp.asarray(positions),
                                                jk, jv, jnp.asarray(cache_pos),
                                                act_dtype=jnp.float32)
    out, k, v = attention.attention_decode(tp, torch.tensor(x), cfg,
                                           torch.tensor(positions).long(), tk, tv,
                                           torch.tensor(cache_pos).long(),
                                           act_dtype=torch.float32)
    assert rk.dtype == jnp.float32 and k.dtype == torch.float32
    assert _rel(out, ref_out) <= F32_ATTN
    assert _rel(k, rk) <= F32 and _rel(v, rv) <= F32


def test_attention_decode_in_place_and_outside_slot():
    """A bf16 model writes into its bf16 cache in place; a slot outside
    [0, W) writes nothing, as the reference's all-zero one-hot row."""
    cfg = get_smoke_config("qwen2.5-3b")
    ref_cfg, jp, tp = _attention_params(cfg.replace(dtype="bfloat16"), 7)
    tp = {k: v.bfloat16() for k, v in tp.items()}
    B, W = 2, 8
    k0 = torch.zeros((B, W, 2, 16), dtype=torch.bfloat16)
    v0 = torch.zeros_like(k0)
    x = torch.randn((B, 1, cfg.d_model), generator=torch.Generator().manual_seed(0)).bfloat16()
    pos = torch.tensor([2, 9])
    out, k, v = attention.attention_decode(tp, x, cfg, pos, k0, v0, pos,
                                           act_dtype=torch.bfloat16)
    assert k is k0 and v is v0 and torch.isfinite(out.float()).all()
    assert k0[0, 2].abs().sum() > 0 and k0[1].abs().sum() == 0
    ref_out, rk, _ = ref_attn.attention_decode(
        {n: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for n, t in tp.items()},
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), ref_cfg, jnp.asarray(pos.numpy()),
        jnp.zeros((B, W, 2, 16), jnp.bfloat16), jnp.zeros((B, W, 2, 16), jnp.bfloat16),
        jnp.asarray(pos.numpy()), act_dtype=jnp.bfloat16)
    assert np.array_equal(k0.float().numpy(), np.asarray(rk.astype(jnp.float32)))
    assert _rel(out, ref_out) <= BF16_ONE_ROUNDING
