"""Rank program of ``tests/test_torch_lm_mesh.py``: a module-level function
(spawned ranks unpickle it by name) that imports no JAX.

Each rank builds the same seeded float32 SMOKE model, runs a prefill and
one train step's gradients on plain tensors, then the same through the
parameters and batch placed on a real ("data", "model") mesh over the
rank's gloo world, and returns both as numpy (the mesh's gathered whole).
"""

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import _value_and_grads
from repro_torch.models import sharding
from repro_torch.models import transformer as tr
from repro_torch.tree import tree_keys

BATCH, SEQ, SEED = 4, 64, 7


def _np(t):
    return t.detach().float().numpy()


def mesh_against_plain(grid, arrays, archs, model, data):
    """For each arch: ``{"logits": (mesh, plain), "grads": {path: (mesh,
    plain)}, "placements": {path: str}}`` of a 4 x 64 prefill and one
    train step's gradients."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(model=model, data=data, device="cpu")
    assert tuple(mesh.shape) == (data, model), mesh
    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch).replace(param_dtype="float32", dtype="float32")
        params = tr.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        g = torch.Generator().manual_seed(SEED + 1)
        tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g)
        targets = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=g)
        batch = {"tokens": tokens, "targets": targets}
        with torch.no_grad():
            want, _ = tr.prefill(params, cfg, {"tokens": tokens})
        _, _, want_g = _value_and_grads(cfg, params, batch)

        placed = sharding.param_shardings(params, mesh)
        at = sharding.to_placements(("data", None), mesh)
        placed_batch = {k: distribute_tensor(v, mesh, at, src_data_rank=None)
                        for k, v in batch.items()}
        with sharding.set_mesh(mesh), implicit_replication():
            with torch.no_grad():
                got, _ = tr.prefill(placed, cfg, {"tokens": placed_batch["tokens"]})
            got = got.full_tensor()
            _, _, got_g = _value_and_grads(cfg, placed, placed_batch)
            got_g = [t.full_tensor() for t in got_g]
        paths = list(tree_keys(params))
        out[arch] = {
            "logits": (_np(got), _np(want)),
            "grads": {p: (_np(a), _np(b)) for p, a, b in zip(paths, got_g, want_g)},
            "placements": {p: str(t.placements) for p, t in tree_keys(placed).items()}}
    return out
