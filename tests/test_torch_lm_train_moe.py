"""Training's loss and gradients against the reference's, part 3 of 4: the
MoE architectures (tolerances in ``tests/_torch_lm_train_ref.py``); the MoE
layer's aux loss and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_train_ref import (  # noqa: F401 (one_thread: autouse)
    check_bfloat16, check_float32, leaf_rel, one_thread)
from repro.configs import get_smoke_config as ref_smoke
from repro.models import moe as ref_moe
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tree_keys
from repro_torch.models import moe

ARCHS = ("deepseek-v2-236b", "arctic-480b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_float32(arch):
    check_float32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bfloat16(arch):
    check_bfloat16(arch)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_moe_aux_and_gradients_match_reference(arch):
    """The MoE layer alone in float32, the reference's ``init_moe`` weights:
    the Switch aux loss within rel 1e-6, and the gradients of
    ``sum(out * w) + aux`` (w a fixed random cotangent) with respect to the
    input, the router (through the renormalized top-k gates and, for the
    aux, the softmax), the routed experts' and the shared or dense FFN's
    weights within 1e-4 of each leaf's scale (measured up to ~1e-6). Two
    groups of 64 tokens at capacity factor 0.5 (12 slots an expert): some
    (token, choice) pairs are dropped and take no gradient in either."""
    S = 128
    kw = dict(dtype="float32", moe_group_size=64, moe_capacity_factor=0.5)
    cfg = get_smoke_config(arch).replace(**kw)
    ref_cfg = ref_smoke(arch).replace(**kw)
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(5), ref_cfg, jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)

    def ref_obj(p, xx):
        out, aux = ref_moe.moe_forward(p, xx, ref_cfg, act_dtype=jnp.float32)
        return jnp.sum(out * w) + aux, aux

    (_, ref_aux), (ref_gp, ref_gx) = jax.value_and_grad(ref_obj, argnums=(0, 1), has_aux=True)(
        ref_p, jnp.asarray(x))
    p = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a), requires_grad=True), ref_p)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.moe_forward(p, xt, cfg, act_dtype=torch.float32)
    keyed = tree_keys(p)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [xt, *keyed.values()])
    assert abs(float(aux.detach()) - float(ref_aux)) <= 1e-6 * float(ref_aux)
    ref_keyed = tree_keys(jax.tree_util.tree_map(np.asarray, ref_gp))
    errs = {"x": leaf_rel(grads[0].double().numpy(), np.asarray(ref_gx, np.float64))}
    for (k, _), g in zip(keyed.items(), grads[1:]):
        errs[k] = leaf_rel(g.double().numpy(), np.asarray(ref_keyed[k], np.float64))
    assert set(errs) == {"x", *ref_keyed}
    assert max(errs.values()) <= 1e-4, errs
    n_g, g = moe._groups(cfg, S)  # the drops happened
    r = moe.route(p, xt.detach().reshape(2 * n_g, g, -1), cfg, torch.float32)
    assert n_g == 2 and int((~r.fits).sum()) > 0


def test_aux_gradient_reaches_the_router_through_the_probabilities():
    """The aux loss alone: its gradient is the router's through the mean
    probabilities (the token fractions are counts and take none), the
    reference's within 1e-4 of scale."""
    arch = "deepseek-v2-236b"
    cfg = get_smoke_config(arch).replace(dtype="float32")
    ref_cfg = ref_smoke(arch).replace(dtype="float32")
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(6), ref_cfg, jnp.float32)
    x = np.random.default_rng(6).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    ref_g = jax.grad(lambda p: ref_moe.moe_forward(p, jnp.asarray(x), ref_cfg,
                                                   act_dtype=jnp.float32)[1])(ref_p)
    p = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a), requires_grad=True), ref_p)
    _, aux = moe.moe_forward(p, torch.from_numpy(x), cfg, act_dtype=torch.float32)
    (g,) = torch.autograd.grad(aux, [p["router"]])
    assert float(g.abs().max()) > 0
    assert leaf_rel(g.double().numpy(), np.asarray(ref_g["router"], np.float64)) <= 1e-4
    for name in ("wi", "wg", "wo"):  # the experts take none of the aux's gradient
        assert float(np.abs(np.asarray(ref_g[name])).max()) == 0.0
