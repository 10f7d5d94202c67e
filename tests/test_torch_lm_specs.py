"""The dry run's input and cache specs (``repro_torch.models.config.input_specs``,
``models.cache.cache_specs``) against the reference's ``ShapeDtypeStruct``s.

For every arch x ``SHAPES`` cell (a documented skip cell is skipped, as in
``tests/test_dryrun_utils.py``): the same key paths, shapes and dtype names,
exactly. The port's leaves are meta tensors (nothing is allocated); a
decode cell's cache is the tree ``init_cache`` builds.
"""

import jax
import pytest
import torch

import repro.configs as ref_configs
from repro.models.cache import cache_specs as ref_cache_specs
from repro.models.sharding import _path_str
from repro_torch import configs
from repro_torch.configs import ARCHS, SHAPES, cells, get_config, get_smoke_config, input_specs
from repro_torch.models.cache import cache_specs, init_cache
from repro_torch.tree import tree_keys


def _ref_fields(tree) -> dict:
    return {_path_str(p): (tuple(leaf.shape), str(leaf.dtype))
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_fields(tree) -> dict:
    return {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in tree_keys(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_match_the_reference(arch, shape):
    cfg = get_config(arch)
    if shape in cfg.shape_skips():
        pytest.skip("documented skip cell")
    mine = input_specs(cfg, shape)
    ref = ref_configs.input_specs(ref_configs.get_config(arch), shape)
    assert _port_fields(mine) == _ref_fields(ref)
    assert all(t.is_meta for t in tree_keys(mine).values())
    if SHAPES[shape]["kind"] == "decode":
        assert mine["tokens"].shape[1] == 1 and "cache" in mine
    else:
        assert tuple(mine["tokens"].shape) == (SHAPES[shape]["batch"], SHAPES[shape]["seq"])


def test_cells_keep_their_skips_and_input_specs_is_re_exported():
    cs = cells(include_skips=True)
    assert len(cs) == len(ARCHS) * len(SHAPES)
    assert len([c for c in cs if c[2]]) == 8  # 8 full-attention archs skip long_500k
    assert cs == ref_configs.cells(include_skips=True)
    assert configs.input_specs is input_specs


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_is_init_caches_tree(arch):
    """``cache_specs`` is ``init_cache``'s tree (paths, shapes, dtypes) on
    the meta device, at a SMOKE size where the real cache is cheap."""
    cfg = get_smoke_config(arch)
    meta = cache_specs(cfg, batch=2, max_seq=32)
    assert all(t.is_meta for t in tree_keys(meta).values())
    assert _port_fields(meta) == _port_fields(init_cache(cfg, 2, 32, device="cpu"))
    assert _port_fields(meta) == _ref_fields(
        ref_cache_specs(ref_configs.get_smoke_config(arch), batch=2, max_seq=32))


def test_input_specs_allocate_nothing():
    """A full-width decode_32k cell of the largest cache is meta only."""
    specs = input_specs(get_config("internvl2-26b"), "decode_32k")
    total = sum(t.numel() * t.element_size() for t in tree_keys(specs).values())
    assert total > 10 ** 11  # ~0.4 TB of cache, described, never made
    assert all(t.device == torch.device("meta") for t in tree_keys(specs).values())
