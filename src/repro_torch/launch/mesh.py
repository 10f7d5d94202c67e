"""Mesh construction, the reference's (``repro.launch.mesh``) over
``torch.distributed.device_mesh.init_device_mesh``.

Single pod : (data=16, model=16)          = 256 ranks
Multi-pod  : (pod=2, data=16, model=16)   = 512 ranks

These are the reference's mesh shapes, kept so that the placements compare
with its own; they are no claim about any machine. A mesh of that size
exists here only over the fake process group (:func:`fake_world`), which
has ranks in name only: it runs no collective, so it serves the dry run's
placements and step tracing. Functions, not module-level constants:
importing this module touches no process group.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..device import resolve_device

#: ``multi_pod`` -> (shape, axis names) of the production mesh
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank 0)
    for the block; it is destroyed on the way out, also on an error. Raises
    if a process group already exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group already exists; a fake world needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
    "model") mesh over the current world, which must have its 256 or 512
    ranks (:func:`fake_world`, whose ranks are CPU ones)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION[multi_pod]
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_host_mesh(model: int = 1, data: int = 1, device="cuda"):
    """A ("data", "model") mesh over the ranks there are: ``model`` and
    ``data`` are clamped as the reference clamps them to its devices.

    Without a process group this starts a world of one over an in-process
    ``HashStore`` (no rendezvous, no network): ``nccl`` on the card, ``gloo``
    for an explicit ``device="cpu"``. The caller ends that world with
    ``torch.distributed.destroy_process_group()``. Under a world the caller
    started, the mesh takes its ranks (at most one a GPU on the card).
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        kw = {}
        if dev.type == "cuda":
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1, **kw)
    n = dist.get_world_size()
    if dev.type == "cuda":
        n = min(n, torch.cuda.device_count())
    model = min(model, n)
    data = max(1, min(data, n // model))
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))
