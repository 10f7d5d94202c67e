"""Shared by ``tests/test_torch_lm_train*.py``: ``loss_fn`` and its
gradients in both packages on one numpy-seeded batch, the reference's
``init_params`` weights carried across by ``convert.lm_params_from_jax``.

The reference's ``jax.value_and_grad`` runs op by op on the CPU (seconds an
architecture), so each result is computed once a module (``lru_cache``)
and the ten architectures are spread over four test files, which
``--dist loadfile`` sends to different workers.

Tolerances, as max |port - reference| / max |reference| of each leaf:

* float32: the loss, ``ce`` and ``aux`` within rel 1e-5, every gradient
  leaf within 1e-4 of its scale (measured: losses 0 to 2.6e-7, gradients
  5.9e-7 to 6.5e-6, the largest mamba2's ``A_log``, whose gradient both
  packages take through the chunked SSD's cumulative sums).
* bfloat16: the loss, ``ce`` and ``aux`` within rel 3e-2 (measured 7e-6 to
  5.3e-4). The gradients are not held to the reference's bf16 gradients:
  in bf16 each package's gradient differs from the float32 gradient by 1-4%
  of a leaf's scale (the two round in other places), and a route that a
  near tie flips between packages moves an MoE's gradients by up to 34%
  (deepseek-v2-236b: the reference's bf16 route differs from both the
  float32 one and the port's). Each leaf's norm-wise error against the
  reference's float32 gradient is held instead to the larger of 5e-2 and
  1.5x the reference's own bf16 error there: the port's bf16 training is
  as accurate as the reference's (measured up to 2.9e-2 of the 5e-2; on
  arctic-480b, where both bf16 runs flip a route against float32, 0.154
  against the reference's own 0.152).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as ref_tr
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax, tree_keys
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves, tree_map

TOL_F32 = 1e-5           # loss, ce, aux
TOL_F32_GRAD = 1e-4      # each gradient leaf, of its scale
TOL_BF16 = 3e-2          # loss, ce, aux
BF16_GRAD_FLOOR = 5e-2   # norm-wise, against the float32 gradient
BF16_GRAD_RATIO = 1.5    # ... or this times the reference's own bf16 error
B = 2
#: sequence lengths that cross the SMOKE SSD's chunk of 32 and the RG-LRU
#: scan's 64 (and recurrentgemma's 16-slot window); 20 for the others
SEQ = {"mamba2-130m": 64, "recurrentgemma-9b": 96}


@pytest.fixture(autouse=True)
def one_thread():
    """The port on one thread (workers of a parallel run share the cores);
    imported into each test module, where it applies to every test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_np(cfg, seed=0) -> dict:
    """Tokens and next-token targets (and an enc-dec model's frame or a
    VLM's prefix embeddings, 0.1 x a standard normal), as numpy."""
    rng = np.random.default_rng(seed)
    S = SEQ.get(cfg.name, 20)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "encdec":
        out["enc_embeds"] = (0.1 * rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                             ).astype(np.float32)
    if cfg.family == "vlm":
        out["prefix_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.num_prefix_tokens, cfg.d_model))).astype(np.float32)
    return out


def to_torch(batch) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def port_loss_and_grads(params, cfg, batch) -> tuple:
    """``(loss, metrics, grads)``: floats, and the gradients as float64
    numpy keyed by ``convert.tree_keys``."""
    alias = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = tr.loss_fn(alias, cfg, to_torch(batch))
    grads = torch.autograd.grad(loss, leaves(alias))
    keyed = dict(zip(tree_keys(alias), grads))
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            {k: g.detach().double().numpy() for k, g in keyed.items()})


@functools.lru_cache(maxsize=None)
def run(arch: str, dtype: str, seed: int = 1) -> dict:
    """Both packages' loss, metrics and gradients for ``arch``'s SMOKE config
    at ``dtype``, weights from ``PRNGKey(seed)``."""
    ref_cfg = ref_smoke(arch).replace(dtype=dtype)
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(seed))
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    batch = batch_np(cfg)

    def ref_loss(p):
        return ref_tr.loss_fn(p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()})

    (ref_l, ref_m), ref_g = jax.value_and_grad(ref_loss, has_aux=True)(ref_params)
    ref_keyed = tree_keys(jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32), np.float64), ref_g))
    loss, metrics, grads = port_loss_and_grads(params, cfg, batch)
    return {"cfg": cfg, "params": params, "batch": batch,
            "ref": (float(ref_l), {k: float(v) for k, v in ref_m.items()}, ref_keyed),
            "port": (loss, metrics, grads)}


def rel(a, b) -> float:
    """|a - b| / |b| for floats (|a - b| where b is 0: a zero aux)."""
    return abs(a - b) / abs(b) if b else abs(a - b)


def leaf_rel(a, b) -> float:
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / scale) if scale else float(np.abs(a).max())


def norm_rel(a, b) -> float:
    scale = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / scale) if scale else float(np.linalg.norm(a))


def check_float32(arch: str) -> dict:
    r = run(arch, "float32")
    (l, m, g), (rl, rm, rg) = r["port"], r["ref"]
    assert set(g) == set(rg)
    errs = {"loss": rel(l, rl), "ce": rel(m["ce"], rm["ce"]), "aux": rel(m["aux"], rm["aux"])}
    assert max(errs.values()) <= TOL_F32, errs
    grad = {k: leaf_rel(g[k], rg[k]) for k in rg}
    worst = max(grad, key=grad.get)
    assert grad[worst] <= TOL_F32_GRAD, (worst, grad[worst])
    return {**errs, "grad": grad[worst]}


def check_bfloat16(arch: str) -> dict:
    r16, r32 = run(arch, "bfloat16"), run(arch, "float32")
    (l, m, g), (rl, rm, rg) = r16["port"], r16["ref"]
    errs = {"loss": rel(l, rl), "ce": rel(m["ce"], rm["ce"]), "aux": rel(m["aux"], rm["aux"])}
    assert max(errs.values()) <= TOL_BF16, errs
    f32 = r32["ref"][2]
    assert set(g) == set(f32)
    for k in f32:
        limit = max(BF16_GRAD_FLOOR, BF16_GRAD_RATIO * norm_rel(rg[k], f32[k]))
        assert norm_rel(g[k], f32[k]) <= limit, (k, norm_rel(g[k], f32[k]), limit)
    return errs
