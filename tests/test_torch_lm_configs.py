"""The LM scaffold's configs, model config, cache layout and parameter tree
(``repro_torch.configs``, ``repro_torch.models``) against the reference's.

Configs are data: every ``CONFIG`` and ``SMOKE`` is compared field for field
(exactly), with every derived property, and every architecture's parameter
tree at full width. The ``train`` mode raises ``NotImplementedError`` naming
ROADMAP item 16c.
"""

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tr
from repro.models.cache import segments_of as ref_segments_of
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import transformer as tr
from repro_torch.models.cache import init_cache, segments_of

DENSE = [a for a in configs.ARCHS if configs.get_config(a).family == "dense"]


def test_registry_matches_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.SHAPES == ref_configs.SHAPES
    for include in (False, True):
        assert configs.cells(include) == ref_configs.cells(include)
    assert DENSE == ["qwen2.5-3b", "internlm2-20b", "stablelm-12b", "granite-8b"]
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_config_matches_reference_field_for_field(arch):
    for getter in ("get_config", "get_smoke_config"):
        mine = getattr(configs, getter)(arch)
        ref = getattr(ref_configs, getter)(arch)
        assert [f.name for f in dataclasses.fields(mine)] == \
            [f.name for f in dataclasses.fields(ref)]
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        for prop in ("resolved_head_dim", "padded_vocab", "is_attention_free",
                     "supports_long_context", "has_decoder"):
            assert getattr(mine, prop) == getattr(ref, prop), prop
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
        assert [mine.layer_kind(i) for i in range(mine.num_layers)] == \
            [ref.layer_kind(i) for i in range(ref.num_layers)]
        assert mine.shape_skips() == ref.shape_skips()
        assert segments_of(mine) == ref_segments_of(ref)
        assert dataclasses.asdict(mine.replace(dtype="float32")) == \
            dataclasses.asdict(ref.replace(dtype="float32"))


def test_qwen_parameter_count():
    cfg = configs.get_config("qwen2.5-3b")
    assert cfg.param_count() == 3_397_101_568
    # the tree holds the final norm besides what param_count counts
    sizes = []
    jax.tree_util.tree_map(lambda s: sizes.append(math.prod(s)), tr.param_shapes(cfg),
                           is_leaf=lambda s: isinstance(s, torch.Size))
    assert sum(sizes) == cfg.param_count() + cfg.d_model


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_tree_matches_reference_at_full_width(arch):
    """The port's tree (on the meta device) and the reference's (abstract,
    ``jax.eval_shape``) at the full config: the same keys, stacking and
    shapes; nothing is allocated."""
    cfg = configs.get_config(arch)
    ref = jax.eval_shape(lambda k: ref_tr.init_params(ref_configs.get_config(arch), k),
                         jax.random.PRNGKey(0))
    ref_shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), ref)
    mine = jax.tree_util.tree_map(tuple, tr.param_shapes(cfg),
                                  is_leaf=lambda s: isinstance(s, torch.Size))
    assert mine == ref_shapes
    assert {s.dtype for s in jax.tree_util.tree_leaves(ref)} == {jnp.dtype(jnp.float32)}


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_cache_layout_matches_reference(arch):
    """``init_cache`` against the reference's ``cache_specs`` (SMOKE, B = 2,
    48 positions): the same leaves, shapes and dtypes, all zero."""
    from repro.models.cache import cache_specs

    cfg = configs.get_smoke_config(arch)
    ref = cache_specs(ref_configs.get_smoke_config(arch), batch=2, max_seq=48)
    mine = init_cache(cfg, batch=2, max_seq=48, device="cpu")
    assert len(mine["segments"]) == len(ref["segments"])
    for seg, ref_seg in zip(mine["segments"], ref["segments"]):
        assert set(seg) == set(ref_seg)
        for slot, leaves in seg.items():
            assert set(leaves) == set(ref_seg[slot])
            for name, t in leaves.items():
                want = ref_seg[slot][name]
                assert tuple(t.shape) == tuple(want.shape), (slot, name)
                assert str(t.dtype).replace("torch.", "") == str(want.dtype), (slot, name)
                assert not t.any()


def test_unported_modes_and_options_raise():
    """Every mode of the reference runs (``train`` since the training
    slice: no cache, the aux loss returned); an unknown mode raises."""
    cfg = configs.get_smoke_config("qwen2.5-3b").replace(dtype="float32")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    positions = torch.arange(4)[None]
    out, cache, aux = tr._run_segments(params, cfg, x, positions, None, None, "train")
    assert out.shape == x.shape and cache is None and float(aux) == 0.0
    with pytest.raises(ValueError, match="mode"):
        tr._run_segments(params, cfg, x, positions, None, None, "generate")


def test_lm_params_from_jax_checks_dtypes_and_shapes():
    cfg = configs.get_smoke_config("qwen2.5-3b")
    ref = jax.tree_util.tree_map(
        np.asarray, ref_tr.init_params(ref_configs.get_smoke_config("qwen2.5-3b"),
                                       jax.random.PRNGKey(3)))
    mine = lm_params_from_jax(ref, cfg, "cpu")
    pairs = zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(ref))
    assert all(np.array_equal(t.numpy(), a) for t, a in pairs)
    assert mine["segments"][0]["s0"]["mix"]["wq"].shape == (2, 64, 64)  # stacked units

    def edited(path, value):
        tree = jax.tree_util.tree_map(lambda a: a, ref)
        node = tree
        for key in path[:-1]:
            node = node[key]
        if value is None:
            del node[path[-1]]
        else:
            node[path[-1]] = value
        return tree

    wq = ("segments", 0, "s0", "mix", "wq")
    with pytest.raises(TypeError, match="float32"):
        lm_params_from_jax(edited(wq, ref["segments"][0]["s0"]["mix"]["wq"].astype(np.float64)),
                           cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_jax(edited(wq, np.zeros((2, 64, 63), np.float32)), cfg, "cpu")
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_jax(edited(("head",), None), cfg, "cpu")
    with pytest.raises(ValueError, match="list"):
        lm_params_from_jax(edited(("segments",), []), cfg, "cpu")


def test_cuda_request_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="cuda"):
        tr.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="cuda"):
        lm_params_from_jax({}, cfg)
    card_generator = types.SimpleNamespace(device=torch.device("cuda"))  # none here
    with pytest.raises(ValueError, match="generator"):
        tr.init_params(cfg, card_generator, "cpu")
