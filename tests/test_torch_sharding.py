"""The LM sharding rules (``repro_torch.models.sharding``) leaf by leaf
against the reference's (``repro.models.sharding``).

The reference's rules run on ``jax.sharding.AbstractMesh`` (no devices),
the port's on :class:`AbstractMesh` or, for placements, on a mesh over the
fake process group (``launch.mesh.fake_world``). Meshes: (1, 1), (16, 16)
and (2, 16, 16). Every comparison is exact: ``tuple(reference_spec) ==
port_spec`` for the parameters of all ten archs, the AdamW moments of the
train state as the dry run places them, and the inputs and the cache of
every runnable ``SHAPES`` cell; each rank's argument bytes of every
runnable cell on both production meshes equal the reference's own
arithmetic (each leaf's bytes divided by the sizes of the axes its spec
names). No process group outlives a test.
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as RefMesh

import repro.configs as ref_configs
from repro.launch.steps import init_train_state as ref_init_train_state
from repro.models import sharding as ref_sharding
from repro.models import transformer as ref_tr
from repro_torch.configs import ARCHS, SHAPES, cells, get_config, input_specs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import sharding
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_keys

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RUNNABLE = [(a, s) for a, s, _ in cells()]


@pytest.fixture(autouse=True)
def no_process_group_left():
    yield
    assert not dist.is_initialized()


def _meshes(name):
    shape, names = MESHES[name]
    return RefMesh(shape, names), sharding.AbstractMesh(shape, names)


def _ref_flat(specs) -> dict:
    return {ref_sharding._path_str(p): tuple(s) for p, s in jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_configs.get_config(arch)
    return jax.eval_shape(lambda k: ref_tr.init_params(cfg, k), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    cfg = ref_configs.get_config(arch)
    return jax.eval_shape(lambda k: ref_init_train_state(cfg, k), jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh):
    ref_mesh, my_mesh = _meshes(mesh)
    ref = _ref_flat(ref_sharding.param_specs(_ref_params(arch), ref_mesh))
    mine = sharding.param_specs(tr.meta_params(get_config(arch)), my_mesh)
    assert mine == ref


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_placements_match_the_reference(arch, mesh):
    """The dry run's train state (``dryrun.train_state_arguments``): the
    parameters and both moments placed as the reference's ``build_cell``
    places them (``param_specs`` of ``opt.mu`` and ``opt.nu``), the step
    replicated."""
    ref_mesh, my_mesh = _meshes(mesh)
    st = _ref_state(arch)
    want = {g: _ref_flat(ref_sharding.param_specs(t, ref_mesh))
            for g, t in (("params", st.params), ("mu", st.opt.mu), ("nu", st.opt.nu))}
    shape, _ = MESHES[mesh]
    with fake_world(math.prod(shape)):
        dmesh = torch.distributed.device_mesh.init_device_mesh(
            "cpu", shape, mesh_dim_names=MESHES[mesh][1])
        state = dryrun.train_state_arguments(get_config(arch), dmesh)
        for g, tree in (("params", state.params), ("mu", state.opt.mu), ("nu", state.opt.nu)):
            got = {p: tuple(t.placements) for p, t in tree_keys(tree).items()}
            assert got == {p: sharding.to_placements(s, dmesh) for p, s in want[g].items()}, g
            assert all(t.to_local().is_meta for t in tree_keys(tree).values())
        assert all(p.is_replicate() for p in state.opt.step.placements)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_input_sharding_specs_match_the_reference(arch, shape, mesh):
    """Tokens, targets, positions, embeddings, and the cache through
    ``_cache_spec``."""
    ref_mesh, my_mesh = _meshes(mesh)
    ref_cfg = ref_configs.get_config(arch)
    ref = _ref_flat(ref_sharding.input_sharding_specs(
        ref_cfg, ref_configs.input_specs(ref_cfg, shape), ref_mesh))
    cfg = get_config(arch)
    assert sharding.input_sharding_specs(cfg, input_specs(cfg, shape), my_mesh) == ref


def test_to_placements_and_batch_axes():
    from torch.distributed.tensor import Replicate, Shard

    m = sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert sharding.batch_axes(m) == ("pod", "data")
    assert sharding.to_placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.to_placements((), m) == (Replicate(),) * 3
    m2 = sharding.AbstractMesh((16, 16), ("data", "model"))
    assert sharding.batch_axes(m2) == ("data",)
    assert sharding.to_placements(("data", None), m2) == (Shard(0), Replicate())


def test_param_specs_shard_big_tensors():
    """On the production mesh, every >=2-D big tensor gets at least one
    sharded dimension (no accidental full replication of weights): the
    reference's test, on the port's rules."""
    mesh = sharding.AbstractMesh((1, 1), ("data", "model"))  # sizes 1: always divides
    params = tr.meta_params(get_config("granite-8b"))
    specs = sharding.param_specs(params, mesh)
    for path, leaf in tree_keys(params).items():
        if leaf.numel() >= 1 << 20:  # >=1M params must shard somewhere
            assert any(a is not None for a in specs[path]), (path, leaf.shape, specs[path])


def _ref_bytes(tree, specs, sizes) -> int:
    """The reference's arithmetic: each leaf's bytes over the product of the
    sizes of the axes its spec names."""
    total = 0
    for (path, leaf), (_, spec) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                       jax.tree_util.tree_leaves_with_path(
                                           specs, is_leaf=lambda s: isinstance(
                                               s, jax.sharding.PartitionSpec))):
        div = 1
        for entry in spec:
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                div *= sizes[a]
        n = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        assert n % div == 0
        total += n // div
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
def test_per_rank_argument_bytes_match_the_reference_arithmetic(multi_pod):
    """Every runnable cell, its production configuration: the dry run's
    per-rank bytes (the sum of ``to_local()`` sizes) by group equal the
    reference's specs' arithmetic."""
    shape, names = MESHES["2x16x16" if multi_pod else "16x16"]
    ref_mesh, sizes = RefMesh(shape, names), dict(zip(names, shape))
    with fake_world(math.prod(shape)):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch, cell_shape in RUNNABLE:
            got = dryrun.argument_bytes(
                dryrun.build_cell(dryrun.cell_config(arch, cell_shape), cell_shape, mesh))
            ref_cfg = ref_configs.get_config(arch)
            specs = ref_configs.input_specs(ref_cfg, cell_shape)
            in_specs = ref_sharding.input_sharding_specs(ref_cfg, specs, ref_mesh)
            want = {"inputs": _ref_bytes({k: v for k, v in specs.items() if k != "cache"},
                                         {k: v for k, v in in_specs.items() if k != "cache"},
                                         sizes),
                    "cache": _ref_bytes(specs["cache"], in_specs["cache"], sizes)
                    if "cache" in specs else 0}
            if SHAPES[cell_shape]["kind"] == "train":
                st = _ref_state(arch)
                want["params"] = _ref_bytes(st.params, ref_sharding.param_specs(
                    st.params, ref_mesh), sizes)
                want["opt"] = 4 + 2 * _ref_bytes(st.opt.mu, ref_sharding.param_specs(
                    st.opt.mu, ref_mesh), sizes)
            else:
                p = _ref_params(arch)
                want["params"] = _ref_bytes(p, ref_sharding.param_specs(p, ref_mesh), sizes)
                want["opt"] = 0
            assert got == want, (arch, cell_shape)
