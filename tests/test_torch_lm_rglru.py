"""The RG-LRU block (``repro_torch.models.rglru``) against the reference's
(``repro.models.rglru``) on numpy-seeded inputs, with the reference's
``init_rglru`` weights, at recurrentgemma-9b's SMOKE widths (d_model and
RG-LRU width 64).

The reference's prefill runs ``jax.lax.associative_scan``; the port runs
the same linear recurrence in chunks of 64 tokens (a causal decay matrix
from cumulative sums of log a_t, the chunk's last h carried on). Held at
S = 1,024 with a carried conv tail and h, in float32 at rel 1e-5 (measured
1.3e-7 to 4.1e-7 on the output and the final h, at the init's decay a_t ~
2e-4 and at a slow one, a_t ~ 0.8); in bf16 at rel 3e-2 (the projections
round to bf16; measured 5e-3 to 6e-3). The chunked scan alone against a
float64 loop of the recurrence: rel 1e-5 (measured 4.0e-8 and 4.7e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import rglru as ref_rglru
from repro_torch.configs import get_smoke_config
from repro_torch.models import rglru

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
S = 1024


def _rel(mine, ref) -> float:
    a = mine.detach().float().numpy().astype(np.float64)
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


def _setup(dtype, lam=None, seed=0):
    cfg = get_smoke_config("recurrentgemma-9b").replace(dtype=dtype)
    ref_cfg = ref_smoke("recurrentgemma-9b").replace(dtype=dtype)
    ref_p = ref_rglru.init_rglru(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    if lam is not None:
        ref_p = dict(ref_p, lam=jnp.full_like(ref_p["lam"], lam))
    p = {k: torch.tensor(np.asarray(v)) for k, v in ref_p.items()}
    return ref_cfg, ref_p, cfg, p


def _state(cfg, rng, B=2):
    R = cfg.rnn_width
    return (rng.standard_normal((B, cfg.ssm_conv - 1, R)).astype(np.float32),
            rng.standard_normal((B, R)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lam", [None, -3.0], ids=["init-decay", "slow-decay"])
def test_forward_against_associative_scan(lam, dtype):
    ref_cfg, ref_p, cfg, p = _setup(dtype, lam)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    conv, h0 = _state(cfg, rng)
    ref_y, (ref_c, ref_h) = ref_rglru.rglru_forward(
        ref_p, jnp.asarray(x).astype(jd), ref_cfg, jnp.asarray(conv).astype(jnp.bfloat16),
        jnp.asarray(h0), act_dtype=jd)
    y, (c, h) = rglru.rglru_forward(p, torch.tensor(x).to(td), cfg,
                                    torch.tensor(conv).to(torch.bfloat16), torch.tensor(h0),
                                    act_dtype=td)
    assert y.dtype == td and h.dtype == torch.float32
    assert _rel(y, ref_y) <= TOL[dtype]
    assert _rel(c, ref_c) <= TOL[dtype] and _rel(h, ref_h) <= TOL[dtype]


@pytest.mark.parametrize("lam", [2.0, -3.0])
def test_linear_scan_against_a_float64_loop(lam):
    _, _, cfg, p = _setup("float32", lam)
    rng = np.random.default_rng(1)
    u = torch.tensor(rng.standard_normal((2, 300, cfg.rnn_width)).astype(np.float32))
    log_a, x_in = rglru._gates(p, u)
    h = rglru.linear_scan(log_a, x_in)                # 300: four chunks and a partial one
    a, x64 = torch.exp(log_a.double()), x_in.double()
    want, hs = torch.zeros_like(x64[:, 0]), []
    for t in range(x64.shape[1]):
        want = a[:, t] * want + x64[:, t]
        hs.append(want)
    want = torch.stack(hs, dim=1)
    assert float((h.double() - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step(dtype):
    ref_cfg, ref_p, cfg, p = _setup(dtype, seed=1)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv, h0 = _state(cfg, rng, B=3)
    ref_y, (ref_c, ref_h) = ref_rglru.rglru_decode(
        ref_p, jnp.asarray(x).astype(jd), ref_cfg, jnp.asarray(conv).astype(jnp.bfloat16),
        jnp.asarray(h0), act_dtype=jd)
    y, (c, h) = rglru.rglru_decode(p, torch.tensor(x).to(td), cfg,
                                   torch.tensor(conv).to(torch.bfloat16), torch.tensor(h0),
                                   act_dtype=td)
    assert _rel(y, ref_y) <= TOL[dtype]
    assert _rel(c, ref_c) <= TOL[dtype] and _rel(h, ref_h) <= TOL[dtype]
