"""The port's mesh and dry run (``repro_torch.launch.mesh``,
``repro_torch.launch.dryrun``) and the ambient-mesh constraint
(``models.sharding.logical_constraint``).

* ``logical_constraint`` returns the very object it was given on a plain
  tensor and whenever no mesh is set, so the models' plain-tensor results
  are untouched (the LM test files hold them bit for bit).
* The SMOKE steps (4 x 64 tokens) of the dense family (qwen2.5-3b), the
  MoE ones (deepseek-v2-236b, arctic-480b) and the SSM (mamba2-130m) run on
  DTensor over a fake (2, 2) mesh: train, prefill and decode, each with its
  collectives counted (a nonzero all-reduce or all-gather count), each
  collective under the mesh axis whose group ran it (an MoE's on the
  experts' model axis among them), and its per-rank flops.
* A step's error names a budget that ran out inside DTensor's planning
  as the budget (DTensor wraps it as a failed sharding propagation).
* A cache placed on a fake (2, 2) mesh (``sharding.cache_shardings``,
  what ``prefill`` builds for DTensor tokens) allocates on each rank only
  its own piece, placed by ``_cache_spec``.
* On a real (1, 1) gloo mesh (a world of one), a prefill through the
  placed parameters gives the plain prefill's logits and cache bit for bit,
  as ``chip_smoke.py``'s ``lm_mesh`` phase checks on the card.
* ``dryrun.main`` writes a full-width record (qwen2.5-3b ``decode_32k`` on
  (16, 16), its step run) and a skip record.
* No process group outlives a test.
"""

import json

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_host_mesh, make_production_mesh
from repro_torch.models import sharding
from repro_torch.models import transformer as tr
from repro_torch.models.cache import cache_specs
from repro_torch.tree import tree_keys


@pytest.fixture(autouse=True)
def no_process_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def test_logical_constraint_returns_its_argument_without_a_distributed_tensor():
    x = torch.randn(4, 8)
    assert sharding.logical_constraint(x, "batch", None) is x
    assert sharding.model_axis_size() == 0
    with sharding.set_mesh(sharding.AbstractMesh((2, 2), ("data", "model"))):
        assert sharding.logical_constraint(x, "batch", "heads") is x
        assert sharding.model_axis_size() == 2
    assert sharding.model_axis_size() == 0  # the block's mesh is gone
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        d = distribute_tensor(x, mesh, (Replicate(), Replicate()), src_data_rank=None)
        assert sharding.logical_constraint(d, "batch", "heads") is d  # no ambient mesh
        with sharding.set_mesh(mesh):
            assert sharding.logical_constraint(x, "batch", "heads") is x
            y = sharding.logical_constraint(d, "batch", "heads")
            assert tuple(y.placements) == (Shard(0), Shard(1))
            assert sharding.logical_constraint(y, "batch", "heads") is y
            with pytest.raises(ValueError):
                sharding.logical_constraint(d, "batch")


def test_fake_world_is_destroyed_on_an_error():
    with pytest.raises(RuntimeError, match="inside"):
        with fake_world(256):
            assert make_production_mesh().shape == (16, 16)
            raise RuntimeError("inside")
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model") and mesh.shape == (2, 16, 16)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b", "arctic-480b",
                                  "mamba2-130m"])
def test_dense_smoke_steps_run_on_a_fake_2x2_mesh(arch):
    """The SMOKE steps of the dense family and of the MoE and SSM ones: the
    MoE's expert products on the model axis (the experts' axis) count a
    collective there."""
    cfg = get_smoke_config(arch)
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        for kind in ("prefill", "decode", "train"):
            cell = dryrun.build(cfg, kind, 4, 64, mesh)
            b = dryrun.argument_bytes(cell)
            assert b["params"] > 0 and b["inputs"] > 0
            assert (b["opt"] > 0) == (kind == "train") and (b["cache"] > 0) == (kind == "decode")
            out = dryrun.trace_step(cell, mesh)
            assert "step_error" not in out, out.get("step_error")
            c = out["collectives"]
            assert c["all-reduce"]["count"] + c["all-gather"]["count"] > 0, (kind, c)
            assert out["collective_bytes_total"] == sum(v["bytes"] for v in c.values()) > 0
            assert out["flops"] > 0
            assert sum(v["count"] for v in c.values()) == sum(
                n for axis in out["axes"].values() for n in axis.values()), (kind, out["axes"])
            if cfg.moe_num_experts:
                assert sum(out["axes"]["model"].values()) > 0, (kind, out["axes"])


def test_a_budget_that_runs_out_in_dtensors_planning_is_named_as_the_budget():
    def wrapped():  # DTensor wraps any error of its planning so
        try:
            raise dryrun.StepBudgetExceeded("the step ran past its 600 s budget")
        except Exception as e:
            raise RuntimeError("Sharding propagation failed for aten.bmm.default(...)\n"
                               f"Error: {e}") from e

    with pytest.raises(RuntimeError) as info:
        wrapped()
    assert dryrun._where(info.value) == ("StepBudgetExceeded: the step ran past its 600 s "
                                         "budget while DTensor planned aten.bmm.default")
    with pytest.raises(RuntimeError) as info:
        raise RuntimeError("Sharding propagation failed for aten.view.default(...)")
    assert dryrun._where(info.value).startswith("RuntimeError: Sharding propagation failed "
                                                "for aten.view.default")


def test_a_placed_cache_allocates_each_ranks_piece_only():
    cfg = get_smoke_config("qwen2.5-3b")
    shapes = cache_specs(cfg, 4, 64)
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        sizes = sharding.mesh_sizes(mesh)
        placed = tree_keys(sharding.cache_shardings(cfg, shapes, mesh, torch.device("cpu")))
        for path, want in tree_keys(shapes).items():
            t = placed[path]
            spec = sharding._cache_spec(cfg, f"cache/{path}", tuple(want.shape), mesh)
            assert tuple(t.placements) == sharding.to_placements(spec, mesh), path
            local = list(want.shape)
            for d, entry in enumerate(spec):
                for axis in () if entry is None else (entry,) if isinstance(entry, str) else entry:
                    local[d] //= sizes[axis]
            x = t.to_local()
            assert t.shape == want.shape and t.dtype == want.dtype, path
            assert list(x.shape) == local and x.device.type == "cpu", path
            assert not x.any(), path
        assert any(t.to_local().numel() < t.numel() for t in placed.values())


def test_prefill_through_placed_parameters_is_bit_for_bit_on_a_1x1_mesh():
    cfg = get_smoke_config("qwen2.5-3b")
    params = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=torch.Generator().manual_seed(1))
    want_logits, want_cache = tr.prefill(params, cfg, {"tokens": tokens})
    mesh = make_host_mesh(device="cpu")
    try:
        assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("data", "model")
        placed = sharding.param_shardings(params, mesh)
        for path, t in tree_keys(placed).items():  # each shard the whole leaf
            assert torch.equal(t.to_local(), tree_keys(params)[path]), path
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor.experimental import implicit_replication

        tok = distribute_tensor(tokens, mesh, sharding.to_placements(("data", None), mesh),
                                src_data_rank=None)
        with sharding.set_mesh(mesh), implicit_replication():
            logits, cache = tr.prefill(placed, cfg, {"tokens": tok})
        assert torch.equal(logits.full_tensor(), want_logits)
        got = tree_keys(cache)
        for path, t in tree_keys(want_cache).items():
            assert torch.equal(got[path].full_tensor(), t), path
    finally:
        dist.destroy_process_group()


def test_dryrun_main_writes_a_record_and_a_skip_record(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--mesh", "single"])
    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "long_500k", "--mesh", "both"])
    out = tmp_path / "artifacts" / "dryrun"
    rec = json.loads((out / "qwen2.5-3b__decode_32k__pod16x16.json").read_text())
    assert rec["devices"] == 256 and rec["params"] == 3397101568
    assert "step_error" not in rec, rec.get("step_error")
    assert rec["memory"]["argument_size_in_bytes"] == sum(rec["argument_bytes"].values())
    assert rec["argument_bytes"]["cache"] == 36 * 2 * 8 * 2048 * 2 * 128 * 2  # B/16, W/16
    assert set(rec["collectives"]) >= set(dryrun.COLLECTIVES)
    assert rec["collectives"]["all-gather"]["count"] > 0 and rec["flops"] > 0
    assert all(rec[k] is None for k in ("bytes_accessed", "hlo_ops", "lower_s", "compile_s"))
    assert "bytes_accessed" in rec["unavailable"]
    for mesh in ("pod16x16", "pod2x16x16"):
        skip = json.loads((out / f"qwen2.5-3b__long_500k__{mesh}.json").read_text())
        assert set(skip) == {"arch", "shape", "mesh", "skipped"}
    assert "qwen2.5-3b x decode_32k x pod16x16" in capsys.readouterr().out
