"""The MoE layer (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on numpy-seeded inputs, with the reference's
``init_moe`` weights, at the SMOKE widths of deepseek-v2-236b (8 experts,
top-2, one shared expert) and arctic-480b (8 experts, top-2, a dense
residual FFN).

Tolerances, as max |port - reference| / max |reference|: float32 rel 1e-5
(the same float32 steps; the combine sums each token's k gated rows where
the reference contracts over every (expert, slot), the rest zeros); bf16
rel 3e-2 (every product rounds to bf16). The aux loss at rel 1e-6 (float32
means). The port runs only the experts that hold a token; the routing
(top-k, queue positions, drops) is compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import moe as ref_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel(mine, ref) -> float:
    a = mine.detach().float().numpy().astype(np.float64)
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32), np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(b).max())


def _setup(arch, seed=0, **kw):
    cfg = get_smoke_config(arch).replace(**kw)
    ref_cfg = ref_smoke(arch).replace(**kw)
    ref_p = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    p = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), ref_p)
    return ref_cfg, ref_p, cfg, p


def _both(arch, dtype, S, seed=0, router=None, **kw):
    ref_cfg, ref_p, cfg, p = _setup(arch, seed, **kw)
    if router is not None:
        ref_p = dict(ref_p, router=jnp.asarray(router))
        p = dict(p, router=torch.tensor(router))
    jd, td = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ref_out, ref_aux = ref_moe.moe_forward(ref_p, jnp.asarray(x).astype(jd), ref_cfg,
                                           act_dtype=jd)
    xt = torch.tensor(x).to(td)
    out, aux = moe.moe_forward(p, xt, cfg, act_dtype=td)
    assert out.dtype == td
    n_g, g = moe._groups(cfg, S)
    routing = moe.route(p, xt.reshape(2 * n_g, g, -1), cfg, td)
    return out, aux, ref_out, ref_aux, routing


def _dropped(routing) -> int:
    return int((~routing.fits).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [128, 100, 20], ids=["two-groups", "one-group-of-S", "S<group"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_moe_forward(arch, S, dtype):
    """Group size 64: S = 128 routes two groups of 64, S = 100 one group of
    100 (64 does not divide it), S = 20 one group of 20."""
    out, aux, ref_out, ref_aux, routing = _both(arch, dtype, S)
    assert routing.top_i.shape[:2] == ((4, 64) if S == 128 else (2, S))
    assert _rel(out, ref_out) <= TOL[dtype]
    assert abs(float(aux) - float(ref_aux)) <= 1e-6 * abs(float(ref_aux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_capacity_drops_match_reference(arch, dtype):
    """Capacity factor 0.25: C = 8 (int(64 * 2 / 8 * 0.25) + 1, rounded up
    to a multiple of 4) of a 64-token group's 128 choices over 8 experts, so
    at least half of them dropped, in both packages alike."""
    out, _, ref_out, _, routing = _both(arch, dtype, 128, seed=3, moe_capacity_factor=0.25)
    assert routing.capacity == 8 and _dropped(routing) >= 128
    assert _rel(out, ref_out) <= TOL[dtype]


def test_routing_matches_reference_positions():
    """The queue positions are choice-major: a group's first choices fill
    the queues before any second choice; the capacity is the reference's."""
    ref_cfg, ref_p, cfg, p = _setup("deepseek-v2-236b", seed=4, moe_capacity_factor=0.5)
    x = np.random.default_rng(4).standard_normal((1, 64, cfg.d_model)).astype(np.float32)
    r = moe.route(p, torch.tensor(x), cfg, torch.float32)
    assert r.capacity == ref_moe._capacity(64, 2, 8, 0.5) == 12
    top_i, pos = r.top_i[0].numpy(), r.pos[0].numpy()
    for e in range(8):
        order = [(j, t) for j in range(2) for t in range(64) if top_i[t, j] == e]
        assert [pos[t, j] for j, t in order] == list(range(len(order)))
    # the reference's combine tensor holds a gate where the port keeps a choice
    logits = jnp.asarray(x) @ ref_p["router"]
    top_p, ref_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), 2)
    assert np.array_equal(np.asarray(ref_i)[0], top_i)
    assert _dropped(r) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_ties_take_the_lower_expert(dtype):
    """Duplicate router columns give exactly equal probabilities; as
    ``jax.lax.top_k``, the lower expert comes first, and the outputs agree."""
    ref_cfg, ref_p, cfg, p = _setup("deepseek-v2-236b", seed=5)
    router = np.asarray(ref_p["router"]).copy()
    router[:, 5] = router[:, 1]
    router[:, 6] = router[:, 2]
    router[:, 7] = router[:, 1]
    out, _, ref_out, _, routing = _both("deepseek-v2-236b", dtype, 64, seed=5, router=router)
    probs = routing.probs
    assert torch.equal(probs[..., 1], probs[..., 5]) and torch.equal(probs[..., 1], probs[..., 7])
    top_i = routing.top_i
    first_tie = (top_i[..., 0] == 1) & (top_i[..., 1] == 5)
    assert bool(first_tie.any())                       # a tie decided by the index
    assert not bool(((top_i[..., 0] == 5) | (top_i[..., 0] == 7)).any())
    assert _rel(out, ref_out) <= TOL[dtype]


def test_unoccupied_experts_are_not_run(monkeypatch):
    """One token routes to k experts: the batched products run over those
    k alone, and the output is the reference's."""
    ref_cfg, ref_p, cfg, p = _setup("deepseek-v2-236b", seed=6)
    seen = []
    bmm = torch.bmm

    def counting_bmm(a, b):
        seen.append(a.shape[0])
        return bmm(a, b)
    monkeypatch.setattr(torch, "bmm", counting_bmm)
    x = np.random.default_rng(6).standard_normal((1, 1, cfg.d_model)).astype(np.float32)
    out, _ = moe.moe_forward(p, torch.tensor(x), cfg, act_dtype=torch.float32)
    ref_out, _ = ref_moe.moe_forward(ref_p, jnp.asarray(x), ref_cfg, act_dtype=jnp.float32)
    assert seen == [cfg.moe_top_k] * 3
    assert _rel(out, ref_out) <= TOL["float32"]


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_mesh_path_matches_reference_on_a_1x1_mesh(arch, monkeypatch):
    """On DTensor operands (a real (1, 1) gloo mesh, a world of one) the
    layer takes the reference's one-hot dispatch and combine over all E
    experts (``moe._experts_onehot``, not the scatter): float32 SMOKE
    widths, the whole model's ``init_params`` carried across by
    ``convert.lm_params_from_jax`` and placed by the parameter rules, two
    64-token groups; ``out`` and ``aux`` within rel 1e-5 of the
    reference's ``moe_forward``."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro.models import transformer as ref_tr
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding
    from repro_torch.tree import tree_map

    kw = dict(param_dtype="float32", dtype="float32")
    cfg, ref_cfg = get_smoke_config(arch).replace(**kw), ref_smoke(arch).replace(**kw)
    ref_params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, ref_params), cfg,
                                device="cpu")
    ref_p = jax.tree_util.tree_map(lambda a: a[0], ref_params["segments"][0]["s0"]["moe"])
    x = np.random.default_rng(7).standard_normal((2, 128, cfg.d_model)).astype(np.float32)
    ref_out, ref_aux = ref_moe.moe_forward(ref_p, jnp.asarray(x), ref_cfg,
                                           act_dtype=jnp.float32)
    ran = []
    onehot, scatter = moe._experts_onehot, moe._experts_scatter
    monkeypatch.setattr(moe, "_experts_onehot", lambda *a: ran.append("onehot") or onehot(*a))
    monkeypatch.setattr(moe, "_experts_scatter", lambda *a: ran.append("scatter") or scatter(*a))
    mesh = make_host_mesh(device="cpu")
    try:
        placed = sharding.param_shardings(params, mesh)
        p = tree_map(lambda t: t[0], placed["segments"][0]["s0"]["moe"])
        xd = distribute_tensor(torch.tensor(x), mesh,
                               sharding.to_placements(("data", None, None), mesh),
                               src_data_rank=None)
        with sharding.set_mesh(mesh), implicit_replication():
            out, aux = moe.moe_forward(p, xd, cfg, act_dtype=torch.float32)
        out, aux = out.full_tensor(), aux.full_tensor()
    finally:
        dist.destroy_process_group()
    assert ran == ["onehot"]
    assert _rel(out, ref_out) <= 1e-5
    assert abs(float(aux) - float(ref_aux)) <= 1e-5 * abs(float(ref_aux))
