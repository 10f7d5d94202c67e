"""The transformer's prefill and decode (``repro_torch.models.transformer``)
for every architecture against the reference's, with the reference's
``init_params`` weights carried across by ``convert.lm_params_from_jax``.

Tolerances, as max |port - reference| / max |reference|:

* float32 models: rel 1e-5 for the prefill logits, every cache leaf after
  the prefill, and 4 decode steps' logits and caches, the port decoding
  both from its own prefill cache and from the reference's (measured
  2.0e-7 to 5.2e-7: the same float32 steps, sums in another order), each
  leaf in the reference's dtype.
* bf16 cache values of a float32 model that round to the other bf16
  neighbour: the K/V, latents and conv tails are bf16 in both packages,
  and a float32 value on a rounding boundary may round to either side.
  The runs of :data:`F32_FLIPS` have such elements (the counts measured);
  each is held to its own bf16 unit plus 1e-5 of the leaf's scale, and the
  port's decode from its own cache to :data:`OWN_CACHE_TOL`. Every other
  run, the dense archs' among them, has none.
* bf16 models: rel 3e-2 (measured 4.0e-3 to 1.5e-2 over the ten archs):
  every product rounds to bf16 (2**-8), and the reference's SiLU rounds
  four more times on the CPU (see ``tests/test_torch_lm_layers.py``).
* the port's own decode against a teacher-forced prefill: rel 5e-3, the
  reference's own check (``tests/test_models.py``, MoE models at capacity
  factor 8.0 so that the prefill drops no token); decode reads the bf16
  cache where the prefill attends to float32 K/V.

Enc-dec models take ``enc_embeds`` and VLMs ``prefix_embeds``, made as the
reference's ``tests/test_models.py::_batch`` makes them (0.1 x a standard
normal, here in float32 numpy, cast by each package to its compute dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as ref_tr
from repro_torch.configs import get_smoke_config
from repro_torch.convert import cache_arrays, lm_params_from_jax, tree_keys
from repro_torch.models import transformer as tr

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SELF_TOL = 5e-3
B, S, T = 2, 20, 4

#: float32 runs, by (arch, weight seed), whose caches hold bf16 elements
#: rounded to the other neighbour: the elements a cache (measured; the leaf,
#: the largest difference over the leaf's scale, the port's decode from its
#: own cache against the reference's logits). Seed 1 is
#: ``test_prefill_and_decode_match_reference``, seed 6
#: ``test_attn_probs_bf16_matches_reference``.
F32_FLIPS = {
    ("deepseek-v2-236b", 1): 1,    # c, 1.6e-4; decode 5.0e-6
    ("arctic-480b", 1): 1,         # v, 1.0e-5; decode 5.2e-7
    ("whisper-base", 1): 5,        # ck 1 and cv 4, 1.1e-3; decode 1.8e-5
    ("recurrentgemma-9b", 1): 1,   # conv, 1.7e-5 (1.5e-3 after decode); 5.0e-7
    ("stablelm-12b", 6): 1,        # v, 1.9e-4; decode 6.0e-6
    ("granite-8b", 6): 1,          # v, 1.9e-4; decode 6.0e-6
    ("deepseek-v2-236b", 6): 1,    # r, 1.1e-3; decode 3.5e-5
    ("whisper-base", 6): 4,        # ck 3 and k 1, 2.9e-4; decode 2.3e-6
}
#: the port's float32 decode from its own prefill cache where that cache
#: holds such an element: 3.5e-5 the largest reading, about 3x that (and
#: chip_smoke.py's LM_OWN_CACHE_REL)
OWN_CACHE_TOL = 1e-4


def _rel(mine, ref) -> float:
    a = np.asarray(mine, np.float64)
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cache_rel(mine, ref, tol, flips=0) -> float:
    """The largest relative difference of two caches' leaves, after checking
    that they have the same keys and each leaf the reference's dtype.

    ``flips`` elements in all may differ by more than ``tol`` of their
    leaf's scale, each by at most its own bf16 unit plus that: a value
    rounded to the other bf16 neighbour, in a bf16 leaf or in a K/V or
    latent leaf that decode promoted (``transformer.BLENDED``). The others
    give the returned difference."""
    ref_leaves = tree_keys(ref)
    mine_leaves = tree_keys(mine)
    assert set(mine_leaves) == set(ref_leaves)
    got = cache_arrays(mine)
    worst, n_flips = 0.0, 0
    for key, leaf in ref_leaves.items():
        assert str(mine_leaves[key].dtype).replace("torch.", "") == str(leaf.dtype), key
        a = got[key].astype(np.float64)
        b = _np(leaf).astype(np.float64)
        scale = np.abs(b).max()
        diff = np.abs(a - b)
        if flips and (leaf.dtype == jnp.bfloat16 or key.rsplit("/", 1)[1] in tr.BLENDED):
            flip = diff > tol * scale
            ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(a), np.abs(b)))[1] - 8)
            assert np.all(diff[flip] <= ulp[flip] + tol * scale), key
            n_flips += int(flip.sum())
            diff = np.where(flip, 0.0, diff)
        worst = max(worst, float(diff.max() / scale))
    assert n_flips <= flips, n_flips
    return worst


def _port_cache(ref_cache) -> dict:
    """The reference's cache as the port's, each leaf in its dtype."""
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    return {"segments": [
        {slot: {name: torch.tensor(_np(t)).to(dtypes[str(t.dtype)])
                for name, t in leaves.items()} for slot, leaves in seg.items()}
        for seg in ref_cache["segments"]]}


def _models(arch, seed=1, **kw):
    ref_cfg = ref_smoke(arch).replace(**kw)
    cfg = get_smoke_config(arch).replace(**kw)
    ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(seed))
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return ref_cfg, ref_params, cfg, params


def _extras(cfg, seed=0) -> dict:
    """The batch's embeddings besides the tokens, as float32 numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "encdec":
        out["enc_embeds"] = (0.1 * rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                             ).astype(np.float32)
    if cfg.family == "vlm":
        out["prefix_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model))).astype(np.float32)
    return out


def _batches(tokens, extras):
    """The same prompt as the reference's batch and the port's."""
    ref = {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in extras.items()}}
    mine = {"tokens": torch.tensor(tokens).long(),
            **{k: torch.tensor(v) for k, v in extras.items()}}
    return ref, mine


def _run_both(ref_cfg, ref_params, cfg, params, tokens, max_seq, extras=None, flips=0):
    """Prefill S tokens, then T decode steps, in both packages; the port
    decodes from its own prefill cache and, again, from the reference's.
    Checks each stage: the logits and caches within ``TOL``, but the decode
    from the port's own cache within :data:`OWN_CACHE_TOL` where ``flips``
    cache elements may round to the other bf16 neighbour."""
    tol = TOL[cfg.dtype]
    own_tol = OWN_CACHE_TOL if flips else tol
    ref_batch, batch = _batches(tokens[:, :S], extras or {})
    rl, rc = ref_tr.prefill(ref_params, ref_cfg, ref_batch, max_seq=max_seq)
    ml, own = tr.prefill(params, cfg, batch, max_seq=max_seq)
    errs = {"prefill": _rel(ml.float(), _np(rl)),
            "prefill_cache": _cache_rel(own, rc, tol, flips)}
    same = _port_cache(rc)
    own_errs = {}
    for t in range(T):
        tok = tokens[:, S + t:S + t + 1]
        pos = torch.full((B,), S + t)
        rl, rc = ref_tr.decode_step(ref_params, ref_cfg, jnp.asarray(tok),
                                    jnp.full((B,), S + t, jnp.int32), rc)
        ml, own = tr.decode_step(params, cfg, torch.tensor(tok).long(), pos, own)
        own_errs[f"own_decode{t}"] = _rel(ml.float(), _np(rl))
        ml, same = tr.decode_step(params, cfg, torch.tensor(tok).long(), pos, same)
        errs[f"decode{t}"] = _rel(ml.float(), _np(rl))
    errs["own_decode_cache"] = _cache_rel(own, rc, tol, flips)
    errs["decode_cache"] = _cache_rel(same, rc, tol, flips)
    assert max(errs.values()) <= tol, errs
    assert max(own_errs.values()) <= own_tol, own_errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    ref_cfg, ref_params, cfg, params = _models(arch, dtype=dtype)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    flips = F32_FLIPS.get((arch, 1), 0) if dtype == "float32" else 0
    _run_both(ref_cfg, ref_params, cfg, params, tokens, max_seq=S + T + 4,
              extras=_extras(cfg), flips=flips)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_probs_bf16_matches_reference(arch):
    """bf16 softmax probabilities into the PV product (float32 model): the
    reference takes them where H == G (whisper's self attention); elsewhere
    both packages ignore the option."""
    ref_cfg, ref_params, cfg, params = _models(arch, seed=6, dtype="float32",
                                               attn_probs_bf16=True)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    _run_both(ref_cfg, ref_params, cfg, params, tokens, max_seq=S + T + 4,
              extras=_extras(cfg, seed=6), flips=F32_FLIPS.get((arch, 6), 0))


def test_ring_cache_with_window_matches_reference():
    """A 16-slot window under a 20-token prompt: the prefill rolls the last
    16 K/V by S % W, decode writes at position % W and masks what the ring
    has not written."""
    ref_cfg, ref_params, cfg, params = _models("qwen2.5-3b", seed=2, dtype="float32",
                                               attn_window=16)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    _run_both(ref_cfg, ref_params, cfg, params, tokens, max_seq=S + T)


def test_blockwise_prefill_matches_reference():
    """Prefill in 8 x 8 chunks (3 of each, padded) against the reference's."""
    ref_cfg, ref_params, cfg, params = _models("internlm2-20b", seed=3, dtype="float32",
                                               blockwise_q=8, blockwise_kv=8)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + T)).astype(np.int32)
    _run_both(ref_cfg, ref_params, cfg, params, tokens, max_seq=S + T)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forced_prefill(arch):
    """The port on its own: 4 greedy-fed decode steps against a prefill of
    the prompt plus the tokens fed so far (its last logits). The SSM's
    chunk is 32 > S + T, so every prefill length is allowed."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    if cfg.moe_num_experts:
        cfg = cfg.replace(moe_capacity_factor=8.0)
    params = tr.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    toks = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + T)))
    extras = {k: torch.tensor(v) for k, v in _extras(cfg, seed=3).items()}
    _, cache = tr.prefill(params, cfg, {"tokens": toks[:, :S], **extras}, max_seq=S + T)
    for t in range(T):
        dec, cache = tr.decode_step(params, cfg, toks[:, S + t:S + t + 1],
                                    torch.full((B,), S + t), cache)
        full, _ = tr.prefill(params, cfg, {"tokens": toks[:, :S + t + 1], **extras},
                             max_seq=S + T)
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
