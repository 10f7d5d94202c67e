"""Training's loss and gradients (``repro_torch.models.transformer.loss_fn``)
against the reference's ``jax.value_and_grad(loss_fn)``, part 1 of 4: the
SSM and qwen2.5-3b, float32 and bf16 (tolerances in
``tests/_torch_lm_train_ref.py``); the chunked cross entropy; the padded
vocabulary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_train_ref import (  # noqa: F401 (one_thread: autouse)
    batch_np, check_bfloat16, check_float32, to_torch, one_thread)
from repro.models.layers import cross_entropy as ref_cross_entropy
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as tr
from repro_torch.models.layers import cross_entropy
from repro_torch.tree import leaves, tree_map

ARCHS = ("mamba2-130m", "qwen2.5-3b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_float32(arch):
    check_float32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bfloat16(arch):
    check_bfloat16(arch)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m"])
def test_chunked_cross_entropy_matches_unchunked(arch):
    """``loss_chunk`` 8 over 32 tokens (4 chunks, each's logits in its own
    checkpoint) against the whole sequence's logits: the loss within rel
    1e-6, every gradient leaf within 1e-6 of its scale (the same float32
    values, the mean of 4 chunk means against one mean)."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    params = tr.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 33))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "targets": torch.from_numpy(toks[:, 1:])}
    out = []
    for chunk in (0, 8):
        alias = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = tr.loss_fn(alias, cfg.replace(loss_chunk=chunk), batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves(alias))))
    (l0, g0), (l1, g1) = out
    assert abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0))
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_cross_entropy_ignores_vocab_padding():
    """The counterpart of ``tests/test_models.py::
    test_cross_entropy_ignores_vocab_padding``: junk in the padded columns
    moves neither the loss nor the real columns' gradient, takes no
    gradient itself, and the loss is the reference's."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 4, 16)).astype(np.float32)
    tgt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    base = torch.tensor(logits, requires_grad=True)
    loss = cross_entropy(base, torch.from_numpy(tgt), vocab_real=12)
    (g,) = torch.autograd.grad(loss, base)
    spiked = torch.tensor(logits)
    spiked[..., 12:] = 100.0
    spiked.requires_grad_()
    again = cross_entropy(spiked, torch.from_numpy(tgt), vocab_real=12)
    (g2,) = torch.autograd.grad(again, spiked)
    loss, again = loss.detach(), again.detach()
    assert abs(float(again) - float(loss)) <= 1e-6 * float(loss)
    assert torch.equal(g[..., 12:], torch.zeros_like(g[..., 12:]))
    assert torch.equal(g2[..., 12:], torch.zeros_like(g2[..., 12:]))
    assert torch.allclose(g2[..., :12], g[..., :12], rtol=1e-6, atol=1e-7)
    ref = float(ref_cross_entropy(jnp.asarray(logits), jnp.asarray(tgt), vocab_real=12))
    assert abs(float(loss) - ref) <= 1e-6 * ref


def test_loss_fn_takes_int32_and_int64_tokens():
    """The pipeline's int32 arrays and int64 tensors give the same loss."""
    cfg = get_smoke_config("qwen2.5-3b").replace(dtype="float32")
    params = tr.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    b = batch_np(cfg, seed=4)
    as32 = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad():
        l32, _ = tr.loss_fn(params, cfg, as32)
        l64, _ = tr.loss_fn(params, cfg, to_torch(b))
    assert torch.equal(l32, l64)
