"""The port's MoE, SSD and residual-stream paths on meshes that the
production ones stand for, over the fake process group (shapes only):

* The MoE layer on a fake (2, 2) ("data", "model") mesh runs the
  reference's one-hot form: its expert products count a collective on the
  model axis, which carries the experts (``expert`` role), and no host
  fetch (a meta shard has no value to fetch).
* An SSD decode step on a fake (2, 2, 3) ("pod", "data", "model") mesh,
  whose model axis does not divide mamba2's SMOKE heads (4): the decode
  keeps the heads whole, as the state's cache rule does (DTensor cannot
  flatten unevenly sharded heads; the full mamba2-130m's 24 heads on a
  model axis of 16 are such a case).
* One SMOKE train step of qwen2.5-3b on a fake (2, 2, 2) mesh finishes
  within :data:`TRAIN_2x2x2_S` seconds (~25 s on an 8-core CPU). DTensor
  takes minutes to plan one product with a strided shard on such a mesh;
  the heavy loops on each rank's shards and the residual stream held
  whole but for its batch keep every product off one.
* No process group outlives a test.
"""

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.models import moe, sharding
from repro_torch.tree import tree_keys

#: seconds one SMOKE train step on the fake (2, 2, 2) mesh may take
TRAIN_2x2x2_S = 300.0


@pytest.fixture(autouse=True)
def no_process_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_moe_layer_places_its_experts_on_the_model_axis(arch):
    cfg = get_smoke_config(arch)
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        meta = moe.init_moe(torch.Generator(), cfg, torch.float32, "meta")
        specs = {k: sharding._spec_for(f"segments/0/s0/moe/{k}", (1, *v.shape), mesh)[1:]
                 for k, v in tree_keys(meta).items()}
        assert specs["wi"] == ("model", "data", None)    # the reference's EP rule
        p = sharding.place(meta, specs, mesh)
        x = sharding.place(torch.empty(4, 64, cfg.d_model, device="meta"),
                           {"": ("data", None, None)}, mesh)
        counter = dryrun.step_counter(mesh)
        with sharding.set_mesh(mesh), implicit_replication(), counter:
            out, aux = moe.moe_forward(p, x, cfg, act_dtype=torch.bfloat16)
        assert tuple(out.shape) == (4, 64, cfg.d_model) and aux.shape == ()
        assert sum(counter.axes["model"].values()) > 0, counter.axes


def test_ssd_decode_on_a_model_axis_that_does_not_divide_the_heads():
    cfg = get_smoke_config("mamba2-130m")
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    assert nh % 3
    with fake_world(12):
        mesh = init_device_mesh("cpu", (2, 2, 3), mesh_dim_names=("pod", "data", "model"))
        cell = dryrun.build(cfg, "decode", 4, 64, mesh)
        state = [t for k, t in tree_keys(cell.args["cache"]).items() if k.endswith("state")]
        assert state and all(t.placements[2].is_replicate() for t in state)
        out = dryrun.trace_step(cell, mesh)
        assert "step_error" not in out, out.get("step_error")
        assert out["flops"] > 0


def test_smoke_train_step_on_a_fake_2x2x2_mesh_finishes_in_time():
    cfg = get_smoke_config("qwen2.5-3b")
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        cell = dryrun.build(cfg, "train", 4, 64, mesh)
        out = dryrun.trace_step(cell, mesh)
        assert "step_error" not in out, out.get("step_error")
        assert out["step_s"] < TRAIN_2x2x2_S
        assert set(out["axes"]) <= {"pod", "data", "model"}
        assert sum(out["axes"]["pod"].values()) > 0   # the gradients' pure DP over "pod"
