"""Training's loss and gradients against the reference's, part 4 of 4:
enc-dec (whisper-base) and the RG-LRU hybrid (tolerances in
``tests/_torch_lm_train_ref.py``); the RG-LRU scan's gradient against a
float64 loop; remat ``none``/``full``/``dots`` bit for bit.
"""

import numpy as np
import pytest
import torch

from _torch_lm_train_ref import (  # noqa: F401 (one_thread: autouse)
    batch_np, check_bfloat16, check_float32, to_torch, one_thread)
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.models import rglru
from repro_torch.models import transformer as tr
from repro_torch.tree import leaves, tree_map

PART = ("whisper-base", "recurrentgemma-9b")


@pytest.mark.parametrize("arch", PART)
def test_loss_and_grads_match_reference_float32(arch):
    check_float32(arch)


@pytest.mark.parametrize("arch", PART)
def test_loss_and_grads_match_reference_bfloat16(arch):
    check_bfloat16(arch)


def test_linear_scan_gradient_matches_float64_loop():
    """The chunked scan's adjoint (the reverse scan) against autograd
    through a float64 token loop, 200 tokens over 4 chunks: log a's and the
    input's gradients within 1e-5 of their scale (differentiating the
    chunked form itself gave log a's at ~1e-3)."""
    rng = np.random.default_rng(7)
    log_a = -np.abs(rng.standard_normal((2, 200, 16))).astype(np.float32) * 0.3
    x = rng.standard_normal((2, 200, 16)).astype(np.float32)
    w = rng.standard_normal((2, 200, 16))
    la, xt = torch.tensor(log_a, requires_grad=True), torch.tensor(x, requires_grad=True)
    h = rglru.linear_scan(la, xt)
    got = torch.autograd.grad((h.double() * torch.from_numpy(w)).sum(), [la, xt])
    la64 = torch.tensor(log_a, dtype=torch.float64, requires_grad=True)
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    hs, state = [], torch.zeros((2, 16), dtype=torch.float64)
    for t in range(200):
        state = torch.exp(la64[:, t]) * state + x64[:, t]
        hs.append(state)
    want = torch.autograd.grad((torch.stack(hs, 1) * torch.from_numpy(w)).sum(), [la64, x64])
    want_h = torch.stack(hs, 1).detach()
    assert float((h.detach().double() - want_h).abs().max()) <= 1e-5 * float(want_h.abs().max())
    for g, r in zip(got, want):
        assert float((g.double() - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_bits(arch):
    """``remat`` ``none``, ``full`` (each unit recomputed in the backward
    pass) and ``dots`` (the plain products' outputs saved, the rest
    recomputed): the same loss and every gradient bit for bit on the CPU;
    ``full`` also with the chunked cross entropy's own checkpoints."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    params = tr.init_params(cfg, torch.Generator().manual_seed(8), "cpu")
    batch = to_torch(batch_np(cfg, seed=8))
    runs = {}
    for remat, chunk in (("none", 0), ("full", 0), ("dots", 0), ("full", 4), ("none", 4)):
        alias = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, m = tr.loss_fn(alias, cfg.replace(remat=remat, loss_chunk=chunk), batch)
        runs[remat, chunk] = (loss.detach(), m["aux"].detach(),
                              torch.autograd.grad(loss, leaves(alias)))
    for key in (("full", 0), ("dots", 0)):
        assert torch.equal(runs[key][0], runs["none", 0][0]), key
        assert torch.equal(runs[key][1], runs["none", 0][1]), key
        assert all(torch.equal(a, b) for a, b in zip(runs[key][2], runs["none", 0][2])), key
    assert torch.equal(runs["full", 4][0], runs["none", 4][0])
    assert all(torch.equal(a, b) for a, b in zip(runs["full", 4][2], runs["none", 4][2]))


def test_unknown_remat_raises():
    cfg = get_smoke_config("qwen2.5-3b").replace(dtype="float32", remat="some")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="remat"):
        tr.loss_fn(params, cfg, to_torch(batch_np(cfg)))
