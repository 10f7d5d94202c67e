"""``repro_torch.optim`` against the reference's ``repro.optim`` on the same
numpy trees: AdamW, global-norm clipping, the cosine schedule; the in-place
update against its functional form bit for bit; int8 compression's
properties (stochastic rounding from a ``torch.Generator`` cannot give
JAX's bits); ``compressed_psum`` on two gloo ranks.

Tolerances: float32 AdamW parameters and moments within rel 1e-6 of each
leaf's scale over 5 steps (the same float32 operations; the global norm
sums in another order, ``b ** step`` may round in its last bit), bf16
moments within one bf16 unit (2**-8 rel) of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro_torch.core import distributed as D
from repro_torch.optim import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    int8_compress,
    int8_decompress,
    linear_warmup,
)
from repro_torch.tree import leaves, tree_map

from _torch_dist_ranks import compressed_psum_rank

SHAPES = {"a": (7, 5), "b": {"c": (13,), "d": (3, 4, 2)}, "e": [(6,), (2, 9)]}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, v, scale) for v in shapes]
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_matches_reference(moment, grad_scale):
    """5 steps of ``adamw_update`` from the same parameters and gradients
    (the clip active at scale 10), the rate a schedule tensor."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES, grad_scale) for _ in range(5)]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[moment]
    rp = tree_map(jnp.asarray, p0)
    rs = ref_adamw.adamw_init(rp, jdt)
    p = tree_map(torch.tensor, p0)
    s = adamw_init(p, tdt)
    for k, g in enumerate(grads):
        lr = ref_schedule.cosine_schedule(rs.step, 1e-2, 2, 5)
        rp, rs, rm = ref_adamw.adamw_update(tree_map(jnp.asarray, g), rs, rp, lr)
        p, s, m = adamw_update(tree_map(torch.tensor, g), s, p,
                               cosine_schedule(s.step, 1e-2, 2, 5))
        assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= 1e-6 * float(rm["grad_norm"])
    assert int(s.step) == int(rs.step) == 5
    for got, want in zip(leaves(p), jax.tree_util.tree_leaves(rp)):
        assert _rel(got, want) <= 1e-6
    tol = 1e-6 if moment == "float32" else 2.0 ** -8
    for tree, ref in ((s.mu, rs.mu), (s.nu, rs.nu)):
        for got, want in zip(leaves(tree), jax.tree_util.tree_leaves(ref)):
            assert got.dtype == tdt
            assert _rel(got.float(), np.asarray(want.astype(jnp.float32))) <= tol


def _functional(g, m, v, p, lr, step, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, max_norm=1.0):
    """The reference's update transcribed leaf by leaf, out of place."""
    gn = torch.sqrt(sum(torch.dot(x.reshape(-1), x.reshape(-1)) for x in g))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-12), 1.0)
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    out = []
    for gi, mi, vi, pi in zip(g, m, v, p):
        g32 = gi * scale
        m_new = b1 * mi + (1 - b1) * g32
        v_new = b2 * vi + (1 - b2) * g32 * g32
        update = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        update = update + wd * pi
        out.append((pi - lr * update, m_new, v_new))
    return out


def test_inplace_update_is_the_functional_form_bit_for_bit():
    """float32 leaves: the in-place update (one scratch tensor, the gradient
    consumed) gives the functional form's parameters and moments bit for
    bit, over 4 steps."""
    rng = np.random.default_rng(1)
    p = tree_map(torch.tensor, _tree(rng, SHAPES))
    s = adamw_init(p)
    ref_p, ref_m, ref_v = ([t.clone() for t in leaves(p)],
                           [torch.zeros_like(t) for t in leaves(p)],
                           [torch.zeros_like(t) for t in leaves(p)])
    for k in range(4):
        g = tree_map(torch.tensor, _tree(rng, SHAPES, 3.0))
        lr = cosine_schedule(s.step, 1e-2, 2, 4)
        ref = _functional([t.clone() for t in leaves(g)], ref_m, ref_v, ref_p, lr, s.step + 1)
        ref_p, ref_m, ref_v = map(list, zip(*ref))
        p, s, _ = adamw_update(g, s, p, lr)
        for got, want in zip(leaves(p), ref_p):
            assert torch.equal(got, want)
        for got, want in zip(leaves(s.mu) + leaves(s.nu), ref_m + ref_v):
            assert torch.equal(got, want)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    g0 = _tree(rng, SHAPES, 5.0)
    ref, ref_gn = ref_adamw.clip_by_global_norm(tree_map(jnp.asarray, g0), 1.0)
    got, gn = clip_by_global_norm(tree_map(torch.tensor, g0), 1.0)
    assert abs(float(gn) - float(ref_gn)) <= 1e-6 * float(ref_gn)
    for a, b in zip(leaves(got), jax.tree_util.tree_leaves(ref)):
        assert _rel(a, b) <= 1e-6
    assert abs(float(global_norm(got)) - 1.0) <= 1e-5
    small = tree_map(torch.tensor, _tree(rng, SHAPES, 1e-3))  # below the limit: unchanged
    before = [t.clone() for t in leaves(small)]
    clip_by_global_norm(small, 1.0)
    assert all(torch.equal(a, b) for a, b in zip(leaves(small), before))


def test_schedules_match_reference():
    """Every step of a 10-step warmup and a 100-step cosine, and past its
    end (the floor at min_ratio): the same float32 rates."""
    for s in range(0, 121):
        want = float(ref_schedule.cosine_schedule(jnp.asarray(s, jnp.int32), 1e-3, 10, 100))
        got = float(cosine_schedule(torch.tensor(s, dtype=torch.int32), 1e-3, 10, 100))
        assert abs(got - want) <= 1e-6 * want, s
        w = float(ref_schedule.linear_warmup(jnp.asarray(s, jnp.int32), 1e-3, 10))
        assert float(linear_warmup(torch.tensor(s, dtype=torch.int32), 1e-3, 10)) == w
    lrs = [float(cosine_schedule(torch.tensor(s), 1e-3, 10, 100)) for s in range(101)]
    assert lrs[0] < lrs[10] and abs(lrs[10] - 1e-3) < 1e-6
    assert lrs[100] < lrs[50] < lrs[10] and lrs[100] >= 1e-4 - 1e-9


@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1.0), (2, 37.0), (3, 1e3)])
def test_int8_compression_unbiased_and_bounded(seed, scale):
    """The reference's property test: the mean of 64 stochastic roundings
    converges to x (within 0.6 of a quantization step), each within one
    step; the scale is max|x| / 127."""
    gen = torch.Generator().manual_seed(seed)
    x = scale * torch.randn(256, generator=gen)
    dec = torch.stack([int8_decompress(*int8_compress(x, gen)) for _ in range(64)])
    q, s = int8_compress(x, gen)
    q_step = float(x.abs().max()) / 127.0
    assert q.dtype == torch.int8 and abs(float(s) - q_step) <= 1e-6 * q_step
    assert float((dec.mean(0) - x).abs().max()) < 0.6 * q_step
    assert float((dec[0] - x).abs().max()) <= q_step * (1 + 1e-5)


def test_error_feedback_converges():
    """With error feedback the accumulated compressed sum tracks the true
    sum (the reference's test: rel < 0.02 over 50 rounds)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(128, generator=gen) * 0.01
    err = torch.zeros_like(x)
    acc_c, acc_t = torch.zeros_like(x), torch.zeros_like(x)
    for _ in range(50):
        xe = x + err
        dec = int8_decompress(*int8_compress(xe, gen))
        err = xe - dec
        acc_c += dec
        acc_t += x
    assert float(torch.linalg.vector_norm(acc_c - acc_t) / torch.linalg.vector_norm(acc_t)) < 0.02


def test_compressed_psum_on_two_gloo_ranks():
    """Two ranks, 6 rounds with error feedback: both get the same mean each
    round; the first round's is the mean of the two ranks' dequantized
    values (``x - error``) within float32 rounding, within one quantization
    step of the true mean; the running mean of the rounds tracks the true
    mean more closely than one round does."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 300)).astype(np.float32)
    out = D.run_grid(compressed_psum_rank, 2, 1, {"x": x}, ({"seed": 11, "rounds": 6},),
                     device="cpu", timeout=240.0)
    assert [o["rank"] for o in out] == [0, 1]
    a, b = out
    assert np.array_equal(a["means"], b["means"])
    true = x.mean(0)
    first = ((x[0] - a["errors"][0]) + (x[1] - b["errors"][0])) / 2
    assert np.abs(a["means"][0] - first).max() <= 1e-6 * np.abs(x).max()
    q_step = np.abs(x).max(1).max() / 127.0
    assert np.abs(a["means"][0] - true).max() <= q_step
    running = a["means"].mean(0)
    assert np.abs(running - true).max() < np.abs(a["means"][0] - true).max()
