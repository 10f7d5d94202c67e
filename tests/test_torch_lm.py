"""The dense transformer's prefill and decode (``repro_torch.models.transformer``)
against the reference's, with the reference's ``init_params`` weights
carried across by ``convert.lm_params_from_jax``.

Tolerances, as max |port - reference| / max |reference|:

* float32 models: rel 1e-5 for the prefill logits, the K/V cache after the
  prefill and 4 decode steps' logits and caches (measured ~4e-7: the same
  float32 steps, sums in another order). The cache is bf16 in both
  packages; a float32 value on a bf16 rounding boundary may round to the
  other side (one element in the four archs' caches, 1.5e-7 of the max).
* bf16 models: rel 3e-2 (measured 5e-3 to 1.1e-2): every product rounds to
  bf16 (2**-8), and the reference's SiLU rounds four more times on the CPU
  (see ``tests/test_torch_lm_layers.py``).
* the port's own decode against a teacher-forced prefill: rel 5e-3, the
  reference's own check (``tests/test_models.py``); decode reads the bf16
  cache where the prefill attends to float32 K/V.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as ref_tr
from repro_torch.configs import get_smoke_config
from repro_torch.convert import cache_arrays, lm_params_from_jax
from repro_torch.models import transformer as tr

DENSE = ["qwen2.5-3b", "granite-8b", "internlm2-20b", "stablelm-12b"]
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SELF_TOL = 5e-3
B, S, T = 2, 20, 4


def _rel(mine, ref) -> float:
    a = np.asarray(mine, np.float64)
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ref_cache(cache) -> dict:
    return {f"segments/{gi}/{slot}/{name}": _np(t)
            for gi, seg in enumerate(cache["segments"])
            for slot, leaves in seg.items() for name, t in leaves.items()}


def _models(arch, seed=1, **kw):
    ref_cfg = ref_smoke(arch).replace(**kw)
    cfg = get_smoke_config(arch).replace(**kw)
    ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(seed))
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return ref_cfg, ref_params, cfg, params


def _run_both(ref_cfg, ref_params, cfg, params, tokens, max_seq):
    """Prefill S tokens, then T decode steps, in both packages: the
    largest relative difference of the logits and caches at each stage."""
    rl, rc = ref_tr.prefill(ref_params, ref_cfg, {"tokens": jnp.asarray(tokens[:, :S])},
                            max_seq=max_seq)
    ml, mc = tr.prefill(params, cfg, {"tokens": torch.tensor(tokens[:, :S]).long()},
                        max_seq=max_seq)
    assert mc["segments"][0]["s0"]["k"].dtype == torch.bfloat16
    errs = {"prefill": _rel(ml.float(), _np(rl)),
            "prefill_cache": max(_rel(cache_arrays(mc)[k], v) for k, v in _ref_cache(rc).items())}
    for t in range(T):
        tok = tokens[:, S + t:S + t + 1]
        rl, rc = ref_tr.decode_step(ref_params, ref_cfg, jnp.asarray(tok),
                                    jnp.full((B,), S + t, jnp.int32), rc)
        ml, mc = tr.decode_step(params, cfg, torch.tensor(tok).long(),
                                torch.full((B,), S + t), mc)
        errs[f"decode{t}"] = _rel(ml.float(), _np(rl))
    assert {str(t.dtype) for t in jax.tree_util.tree_leaves(rc)} == \
        {str(t.dtype).replace("torch.", "") for t in jax.tree_util.tree_leaves(mc)}
    errs["decode_cache"] = max(_rel(cache_arrays(mc)[k], v) for k, v in _ref_cache(rc).items())
    return errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch, dtype):
    ref_cfg, ref_params, cfg, params = _models(arch, dtype=dtype)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    errs = _run_both(ref_cfg, ref_params, cfg, params, tokens, max_seq=S + T + 4)
    assert max(errs.values()) <= TOL[dtype], errs


def test_ring_cache_with_window_matches_reference():
    """A 16-slot window under a 20-token prompt: the prefill rolls the last
    16 K/V by S % W, decode writes at position % W and masks what the ring
    has not written."""
    ref_cfg, ref_params, cfg, params = _models("qwen2.5-3b", seed=2, dtype="float32",
                                               attn_window=16)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    errs = _run_both(ref_cfg, ref_params, cfg, params, tokens, max_seq=S + T)
    assert max(errs.values()) <= TOL["float32"], errs


def test_blockwise_prefill_matches_reference():
    """Prefill in 8 x 8 chunks (3 of each, padded) against the reference's."""
    ref_cfg, ref_params, cfg, params = _models("internlm2-20b", seed=3, dtype="float32",
                                               blockwise_q=8, blockwise_kv=8)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    errs = _run_both(ref_cfg, ref_params, cfg, params, tokens, max_seq=S + T)
    assert max(errs.values()) <= TOL["float32"], errs


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_teacher_forced_prefill(arch):
    """The port on its own: 4 greedy-fed decode steps against a prefill of
    the prompt plus the tokens fed so far (its last logits)."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    params = tr.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    toks = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + T)))
    _, cache = tr.prefill(params, cfg, {"tokens": toks[:, :S]}, max_seq=S + T)
    for t in range(T):
        dec, cache = tr.decode_step(params, cfg, toks[:, S + t:S + t + 1],
                                    torch.full((B,), S + t), cache)
        full, _ = tr.prefill(params, cfg, {"tokens": toks[:, :S + t + 1]}, max_seq=S + T)
        assert _rel(dec, full) <= SELF_TOL


def test_serving_params_give_the_bits_of_casting_each_call():
    """A bf16 model: the weights cast once (``serving_params``) against the
    float32 masters cast in every product; the norm scales stay float32."""
    cfg = get_smoke_config("qwen2.5-3b")
    params = tr.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    params["final_norm"]["scale"] += 0.01  # a scale that bf16 would round
    cast = tr.serving_params(params, cfg)
    assert cast["head"].dtype == torch.bfloat16
    assert cast["final_norm"]["scale"] is params["final_norm"]["scale"]
    assert tr.serving_params(params, cfg.replace(dtype="float32"))["head"] is params["head"]
    toks = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S)))
    a, ca = tr.prefill(params, cfg, {"tokens": toks}, max_seq=S + 2)
    b, cb = tr.prefill(cast, cfg, {"tokens": toks}, max_seq=S + 2)
    assert torch.equal(a, b)
    pos = torch.full((B,), S)
    a, _ = tr.decode_step(params, cfg, toks[:, :1], pos, ca)
    b, _ = tr.decode_step(cast, cfg, toks[:, :1], pos, cb)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
