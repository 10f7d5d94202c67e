"""The Mamba-2 block (``repro_torch.models.ssm``) against the reference's
(``repro.models.ssm``) on numpy-seeded inputs, with the reference's
``init_ssm`` weights (its ``A_log``, ``D`` and ``dt_bias`` float32), at
mamba2-130m's SMOKE widths (d_model 64, state 16, heads of 32, chunk 32).

Tolerances, as max |port - reference| / max |reference| of each output:
float32 rel 1e-5 (the same float32 steps: the chunked dual form, the state
carried across chunks, sums in another order); bf16 rel 3e-2 (the
projections and the conv round to bf16; the state stays float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(mine, ref) -> float:
    a = mine.detach().float().numpy().astype(np.float64)
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


def _setup(dtype, seed=0):
    cfg = get_smoke_config("mamba2-130m").replace(dtype=dtype)
    ref_cfg = ref_smoke("mamba2-130m").replace(dtype=dtype)
    ref_p = ref_ssm.init_ssm(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    # a spread of step sizes and decays, so the chunks' states matter
    rng = np.random.default_rng(seed + 100)
    nh = ref_p["A_log"].shape[0]
    ref_p = dict(ref_p, dt_bias=jnp.asarray(rng.uniform(-2, 0, nh).astype(np.float32)),
                 conv_b=jnp.asarray(0.1 * rng.standard_normal(ref_p["conv_b"].shape)
                                    .astype(np.float32)))
    p = {k: torch.tensor(np.asarray(v)) for k, v in ref_p.items()}
    return ref_cfg, ref_p, cfg, p


def test_ssd_chunked_with_initial_state():
    rng = np.random.default_rng(3)
    B, S, nh, P, N = 2, 64, 3, 8, 16
    xh = rng.standard_normal((B, S, nh, P)).astype(np.float32)
    dt = (0.5 * rng.random((B, S, nh)) + 0.1).astype(np.float32)
    A = (-0.5 * rng.random(nh) - 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    s0 = rng.standard_normal((B, nh, P, N)).astype(np.float32)
    ref_y, ref_s = ref_ssm.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), 16,
                                       jnp.asarray(s0))
    y, s = ssm.ssd_chunked(*map(torch.tensor, (xh, dt, A, Bm, Cm)), 16, torch.tensor(s0))
    assert _rel(y, ref_y) <= TOL["float32"] and _rel(s, ref_s) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_state_handoff_across_two_calls(dtype):
    """A 96-token sequence as one call and as two calls of 64 and 32 (the
    second taking the first's conv tail and SSD state), in both packages."""
    ref_cfg, ref_p, cfg, p = _setup(dtype)
    jd, td = DTYPES[dtype]
    x = np.random.default_rng(0).standard_normal((2, 96, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jd), torch.tensor(x).to(td)
    ref_full, (ref_conv, ref_state) = ref_ssm.ssm_forward(ref_p, jx, ref_cfg, act_dtype=jd)
    full, (conv, state) = ssm.ssm_forward(p, tx, cfg, act_dtype=td)
    assert _rel(full, ref_full) <= TOL[dtype]
    assert _rel(conv, ref_conv) <= TOL[dtype] and _rel(state, ref_state) <= TOL[dtype]
    assert state.dtype == torch.float32 and conv.dtype == td

    ref_a, (rc, rs) = ref_ssm.ssm_forward(ref_p, jx[:, :64], ref_cfg, act_dtype=jd)
    ref_b, (rc, rs) = ref_ssm.ssm_forward(ref_p, jx[:, 64:], ref_cfg, rc, rs, act_dtype=jd)
    a, (c1, s1) = ssm.ssm_forward(p, tx[:, :64], cfg, act_dtype=td)
    b, (c2, s2) = ssm.ssm_forward(p, tx[:, 64:], cfg, c1, s1, act_dtype=td)
    assert _rel(a, ref_a) <= TOL[dtype] and _rel(b, ref_b) <= TOL[dtype]
    assert _rel(s2, rs) <= TOL[dtype] and _rel(c2, rc) <= TOL[dtype]
    # the handoff gives the single call's outputs and state
    assert _rel(torch.cat([a, b], dim=1), full.float().numpy()) <= TOL[dtype]
    assert _rel(s2, state.numpy()) <= TOL[dtype]


def test_length_not_a_multiple_of_the_chunk_raises():
    _, _, cfg, p = _setup("float32")
    x = torch.zeros((1, 48, cfg.d_model))          # chunk 32: 48 is neither < 32 nor 2 x 32
    with pytest.raises(ValueError, match="chunk"):
        ssm.ssm_forward(p, x, cfg, act_dtype=torch.float32)
    ssm.ssm_forward(p, x[:, :20], cfg, act_dtype=torch.float32)   # below the chunk: one chunk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step(dtype):
    ref_cfg, ref_p, cfg, p = _setup(dtype, seed=1)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, cfg.ssm_conv - 1, d_in + 2 * cfg.ssm_state)).astype(np.float32)
    state = rng.standard_normal((3, nh, cfg.ssm_head_dim, cfg.ssm_state)).astype(np.float32)
    ref_out, (ref_conv, ref_state) = ref_ssm.ssm_decode(
        ref_p, jnp.asarray(x).astype(jd), ref_cfg, jnp.asarray(conv).astype(jnp.bfloat16),
        jnp.asarray(state), act_dtype=jd)
    out, (c, s) = ssm.ssm_decode(p, torch.tensor(x).to(td), cfg,
                                 torch.tensor(conv).to(torch.bfloat16), torch.tensor(state),
                                 act_dtype=td)
    assert _rel(out, ref_out) <= TOL[dtype]
    assert _rel(c, ref_conv) <= TOL[dtype] and _rel(s, ref_state) <= TOL[dtype]
