"""Multi-head latent attention (``repro_torch.models.mla``) against the
reference's (``repro.models.mla``) on numpy-seeded inputs, with the
reference's ``init_mla`` weights, at deepseek-v2-236b's SMOKE widths (4
heads of 16, kv_lora 32, rope 16).

Tolerances, as max |port - reference| / max |reference| of each output:
float32 rel 1e-5 (the same float32 steps, sums in another order); bf16 rel
3e-2 (every product rounds to bf16, 2**-8 a rounding). Decode writes the
latent and rope key at ``positions``; a position at or past the cache's
length writes nothing (the reference's all-zero one-hot row) and attends to
every position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import mla as ref_mla
from repro_torch.configs import get_smoke_config
from repro_torch.models import mla

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(mine, ref) -> float:
    a = mine.detach().float().numpy().astype(np.float64)
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


def _setup(dtype, seed=0):
    cfg = get_smoke_config("deepseek-v2-236b").replace(dtype=dtype)
    ref_cfg = ref_smoke("deepseek-v2-236b").replace(dtype=dtype)
    ref_p = ref_mla.init_mla(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    p = {k: torch.tensor(np.asarray(v)) for k, v in ref_p.items()}
    return ref_cfg, ref_p, cfg, p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward(dtype):
    ref_cfg, ref_p, cfg, p = _setup(dtype)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    ref_out, (ref_c, ref_r) = ref_mla.mla_forward(ref_p, jnp.asarray(x).astype(jd), ref_cfg,
                                                  jnp.asarray(pos), act_dtype=jd)
    out, (c, r) = mla.mla_forward(p, torch.tensor(x).to(td), cfg, torch.tensor(pos).long(),
                                  act_dtype=td)
    assert out.dtype == td and c.shape == (2, 24, cfg.mla_kv_lora)
    assert r.shape == (2, 24, cfg.mla_rope_dim)
    for mine, ref in ((out, ref_out), (c, ref_c), (r, ref_r)):
        assert _rel(mine, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_in_chunks(dtype):
    """Prefill in 8 x 8 chunks, 3 of each with the last padded."""
    ref_cfg, ref_p, cfg, p = _setup(dtype, seed=1)
    ref_cfg = ref_cfg.replace(blockwise_q=8, blockwise_kv=8)
    cfg = cfg.replace(blockwise_q=8, blockwise_kv=8)
    jd, td = DTYPES[dtype]
    x = np.random.default_rng(1).standard_normal((1, 21, cfg.d_model)).astype(np.float32)
    pos = np.arange(21, dtype=np.int32)[None]
    ref_out, _ = ref_mla.mla_forward(ref_p, jnp.asarray(x).astype(jd), ref_cfg,
                                     jnp.asarray(pos), act_dtype=jd)
    out, _ = mla.mla_forward(p, torch.tensor(x).to(td), cfg, torch.tensor(pos).long(),
                             act_dtype=td)
    assert _rel(out, ref_out) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_at_and_past_max_seq(dtype):
    """Four rows at positions 5, W - 1, W and W + 3 of a W = 12 cache: the
    first two write their latent, the last two write nothing and read all."""
    ref_cfg, ref_p, cfg, p = _setup(dtype, seed=2)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    W = 12
    x = rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32)
    c0 = rng.standard_normal((4, W, cfg.mla_kv_lora)).astype(np.float32)
    r0 = rng.standard_normal((4, W, cfg.mla_rope_dim)).astype(np.float32)
    positions = np.array([5, W - 1, W, W + 3], np.int32)
    ref_c = jnp.asarray(c0).astype(jnp.bfloat16)
    ref_r = jnp.asarray(r0).astype(jnp.bfloat16)
    ref_out, ref_c2, ref_r2 = ref_mla.mla_decode(
        ref_p, jnp.asarray(x).astype(jd), ref_cfg, jnp.asarray(positions), ref_c, ref_r,
        jnp.asarray(positions), act_dtype=jd)
    c = torch.tensor(c0).to(torch.bfloat16)
    r = torch.tensor(r0).to(torch.bfloat16)
    pos = torch.tensor(positions).long()
    out, c2, r2 = mla.mla_decode(p, torch.tensor(x).to(td), cfg, pos, c, r, pos, act_dtype=td)
    # the blend's dtype: bf16 under a bf16 model, promoted under a float32 one
    assert str(c2.dtype).replace("torch.", "") == str(ref_c2.dtype)
    assert _rel(out, ref_out) <= TOL[dtype]
    assert _rel(c2, ref_c2) <= TOL[dtype] and _rel(r2, ref_r2) <= TOL[dtype]
    # rows 2 and 3 are unchanged; rows 0 and 1 changed only at their position
    c0b = torch.tensor(c0).to(torch.bfloat16).float()
    assert torch.equal(c2[2:].float(), c0b[2:])
    for row, at in ((0, 5), (1, W - 1)):
        keep = [w for w in range(W) if w != at]
        assert torch.equal(c2[row, keep].float(), c0b[row, keep])
        assert not torch.equal(c2[row, at].float(), c0b[row, at])
