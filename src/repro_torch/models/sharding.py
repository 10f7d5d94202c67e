"""Parameter and activation partitioning rules (TP + FSDP + EP), the
reference's (``repro.models.sharding``) on DTensor placements.

Axes: "model" carries tensor and expert parallelism; "data" carries batch
DP and FSDP parameter sharding; "pod" (the multi-pod mesh) carries pure DP,
parameters replicated across pods.

A leaf's spec is a plain tuple, one entry per tensor dimension: ``None``,
an axis name, or a tuple of names (``("pod", "data")``), normalized as the
reference's ``PartitionSpec`` (a one-name tuple is the name), so
``tuple(reference_spec) == port_spec``. A spec function returns a flat
``{path: spec}`` dict over the tree's :func:`tree.tree_keys` paths
(``segments/0/s0/mix/wq``). :func:`to_placements` turns a spec into the
DTensor ``Shard``/``Replicate`` placements of a ``DeviceMesh``.

The rules read only the mesh's axis names and sizes: a ``mesh`` is a
``DeviceMesh`` or any object with ``mesh_dim_names`` and ``shape`` (one
size an axis, :class:`AbstractMesh`), so the specs need no process group.
Any dimension whose size the axis does not divide is replicated.

:func:`logical_constraint` is the reference's named-role placement of an
activation: under an ambient mesh (:func:`set_mesh`, the counterpart of
``jax.set_mesh``) a DTensor is redistributed to the roles' placements;
without one, or on a plain tensor, it returns ``x`` itself, so the models
run unchanged on plain tensors.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import re
from typing import NamedTuple, Optional

import torch

from ..tree import tree_keys, tree_map, tree_map_with_path


class AbstractMesh(NamedTuple):
    """A mesh's axis sizes and names, without devices or ranks."""
    shape: tuple
    mesh_dim_names: tuple


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _entry(axes):
    """A spec entry for a tuple of axis names, as ``PartitionSpec`` keeps it."""
    if axes is None or len(axes) != 1:
        return axes
    return axes[0]


def to_placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh axis that spec entry d names (several axes on one dimension shard
    it in mesh order), ``Replicate()`` on the others. An axis of size 1
    holds the whole tensor either way and is ``Replicate()``: DTensor
    refuses to view a dimension of size 1 sharded on it (a batch of one on
    a (1, 1) mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry,) if isinstance(entry, str) else entry:
            if sizes[axis] > 1:
                out[names.index(axis)] = Shard(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# logical activation constraints (named roles)
# ---------------------------------------------------------------------------
# Roles: "batch" -> the (pod,) data axes; "heads"/"vocab"/"expert"/"ffn" ->
# the model axis; None/"seq"/other -> unconstrained (replicated). A role
# applies only where its axes divide the dimension.

_MODEL_ROLES = ("heads", "vocab", "expert", "ffn")
_AMBIENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` the ambient mesh of :func:`logical_constraint` and
    :func:`model_axis_size` inside the block."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def model_axis_size() -> int:
    """Size of the ambient mesh's "model" axis (0 when no mesh is set)."""
    mesh = _AMBIENT.get()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 0
    return int(mesh_sizes(mesh)["model"])


def _role_spec(roles, shape, mesh) -> tuple:
    """The spec of named ``roles`` on a tensor of ``shape``."""
    sizes = mesh_sizes(mesh)
    ba = tuple(a for a in ("pod", "data") if a in sizes)
    ba_size = math.prod(sizes[a] for a in ba) if ba else 1
    spec = []
    for role, dim in zip(roles, shape):
        if role == "batch" and ba and dim % ba_size == 0:
            spec.append(_entry(ba))
        elif role in _MODEL_ROLES and dim % sizes["model"] == 0:
            spec.append("model")
        else:
            spec.append(None)
    return tuple(spec)


def role_placements(roles, shape, mesh) -> tuple:
    """The placements on ``mesh`` of a tensor of ``shape`` whose dimensions
    have the named ``roles`` (those :func:`logical_constraint` gives it)."""
    return to_placements(_role_spec(roles, shape, mesh), mesh)


def on_shards(fn, args, in_roles, out_placements):
    """``fn(*args)`` on each rank's own shards (``local_map``) when an
    argument is a DTensor, else ``fn(*args)`` itself. Each tensor argument
    is placed by its ``in_roles`` entry (:func:`role_placements`;
    redistributed where it differs, a plain tensor taken as the same on
    every rank); an argument that is no tensor has None there. The outputs
    are DTensors of ``out_placements`` (one tuple of placements, or a list
    of them for several outputs), of the local results' sizes times their
    shards.

    The port's heavy loops (the attention's chunks, the SSD chunks, the
    RG-LRU scan, the MoE's expert products) run so under a mesh: their
    operations are plain ones on each rank, which DTensor neither
    dispatches nor plans. DTensor can take minutes to plan one product on
    a 3-D mesh (one whose batch joins dimensions sharded on the batch axes
    and the model axis, a strided shard), and a 32k-token prefill runs
    ~10^5 such operations a layer. The values are the plain function's on
    each shard.

    Gradients: an argument replicated on a mesh axis where an output is
    not (the MoE's tokens against its expert buffers, the expert weights
    against the batch, the SSD's ``A``, ``B`` and ``C`` against the batch
    or the heads) gets from each rank only that rank's part of its
    gradient. It is marked ``Partial()`` there (:func:`_grad_placements`),
    and the redistribution into its roles' placements, made for every
    argument, sums it in the backward pass into the argument's own
    placement, as DTensor's dispatch of the same products would."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    meshes = [a.device_mesh for a in args if isinstance(a, DTensor)]
    if not meshes:
        return fn(*args)
    mesh = meshes[0]
    outs = [out_placements] if isinstance(out_placements, tuple) else list(out_placements)
    placed, places, grads = [], [], []
    for a, roles in zip(args, in_roles):
        if isinstance(a, torch.Tensor):
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            p = role_placements(roles, a.shape, mesh)
            a = a.redistribute(mesh, p)
            places.append(p)
            grads.append(_grad_placements(p, outs))
        else:
            places.append(None)
            grads.append(None)
        placed.append(a)
    out = (list(out_placements) if isinstance(out_placements, tuple)
           else tuple(list(p) for p in out_placements))
    return local_map(fn, out_placements=out, in_placements=tuple(places),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*placed)


def _grad_placements(placements, outs) -> tuple:
    """The placements of the gradient that ``fn`` computes on one rank for
    an argument of ``placements``, given its outputs' ``outs``: a partial
    sum (``Partial()``) on each mesh axis where the argument is replicated
    and an output is not, else the argument's own."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if p.is_replicate() and any(not o[i].is_replicate() for o in outs)
                 else p for i, p in enumerate(placements))


def logical_constraint(x, *roles):
    """``x`` placed by its dimensions' roles: a DTensor under an ambient mesh
    with a "model" axis is redistributed, and so is its gradient in the
    backward pass (as ``jax.lax.with_sharding_constraint`` constrains the
    cotangent too); anything else comes back as it is, the very object."""
    mesh = _AMBIENT.get()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    if len(roles) != x.ndim:
        raise ValueError(f"{len(roles)} roles {roles} for a tensor of shape {tuple(x.shape)}")
    placements = role_placements(roles, x.shape, x.device_mesh)
    if not x.requires_grad:
        return x if tuple(x.placements) == placements else x.redistribute(
            x.device_mesh, placements)
    return _Constrain.apply(x, placements)


class _Constrain(torch.autograd.Function):
    """Redistribute a DTensor, and its gradient, to one placement."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if tuple(x.placements) == placements:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------
# (path regex, code): the code gives the axis of each *trailing* dimension
# (the stacked layer dimension, when present, is always None).
# "T" = model/tensor axis, "F" = fsdp (data) axis, "." = replicated.
_RULES: list[tuple[str, str]] = [
    (r"embed/tok$", "TF"),
    (r"head$", "FT"),
    (r"(mix|cross)/w[qkv]$", "FT"),
    (r"(mix|cross)/b[qkv]$", "T"),
    (r"(mix|cross)/wo$", "TF"),
    (r"mix/w_dkv$", "F."),          # MLA latent down-projection (small)
    (r"mix/w_krope$", "F."),
    (r"mix/[kv]_up$", ".T"),
    (r"moe/router$", "F."),
    (r"moe/w[ig]$", "TF."),         # (E, D, Fe): EP on experts
    (r"moe/wo$", "T.F"),
    (r"(shared|dense)/w[ig]$", "FT"),
    (r"(shared|dense)/wo$", "TF"),
    (r"mlp/w[ig]$", "FT"),
    (r"mlp/wo$", "TF"),
    (r"mix/in_proj$", "F."),        # mamba2's fused zxBCdt projection
    (r"mix/out_proj$", "TF"),
    (r"mix/w_(gate|rec_in)$", "FT"),
    (r"mix/w_[ri]$", ".T"),
    (r"mix/(lam|conv_b|norm_scale)$", "T"),
    (r"mix/conv_w$", ".T"),
    (r"mix/(A_log|D|dt_bias)$", "."),
    (r"(ln1|ln2|ln_x|final_norm)/(scale|bias)$", "."),
]
_STACKED = re.compile(r"segments/\d+/s\d+/|encoder/layers/")


def _spec_for(path: str, shape: tuple, mesh) -> tuple:
    sizes = mesh_sizes(mesh)
    tp, fsdp = sizes["model"], sizes["data"]
    stacked = bool(_STACKED.search(path))

    code: Optional[str] = None
    for pat, c in _RULES:
        if re.search(pat, path):
            code = c
            break
    if code is None:
        return ()  # replicate unknowns

    trailing = shape[1:] if stacked else shape
    if len(code) != len(trailing):
        return ()  # rule/shape mismatch -> safe fallback

    axes = []
    for ch, dim in zip(code, trailing):
        if ch == "T" and dim % tp == 0:
            axes.append("model")
        elif ch == "F" and dim % fsdp == 0:
            axes.append("data")
        else:
            axes.append(None)
    if stacked:
        axes = [None] + axes
    return tuple(axes)


def param_specs(params, mesh) -> dict:
    """``{path: spec}`` of a parameter tree (or a tree of the same paths,
    such as the AdamW moments) whose leaves are tensors (meta or fake
    ones too)."""
    return {p: _spec_for(p, tuple(leaf.shape), mesh) for p, leaf in tree_keys(params).items()}


def place(tree, specs: dict, mesh, prefix: str = ""):
    """``tree`` with every leaf a DTensor on ``mesh`` (a ``DeviceMesh``),
    placed by ``specs[prefix + path]`` with ``distribute_tensor``: each rank
    holds the whole leaf and keeps its own piece (a view where it can be
    one; a meta leaf keeps a meta shard). Nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map_with_path(
        lambda p, t: distribute_tensor(t, mesh, to_placements(specs[prefix + p], mesh),
                                       src_data_rank=None), tree)


def param_shardings(params, mesh):
    """``params`` placed by :func:`param_specs` (:func:`place`). Every rank
    must first hold the whole tree (drawn from one seed): on a mesh of more
    than one rank that is the memory the sharding saves, allocated first.
    A rank's own piece cannot be drawn alone, since ``init_params`` draws
    each leaf whole."""
    return place(params, param_specs(params, mesh), mesh)


def input_sharding_specs(cfg, specs: dict, mesh) -> dict:
    """``{path: spec}`` of a cell's inputs (tokens, targets, positions,
    embeddings, and the cache by :func:`_cache_spec`)."""
    ba = batch_axes(mesh)
    sizes = mesh_sizes(mesh)
    ba_size = math.prod(sizes[a] for a in ba)

    def bspec(size):
        # shard the batch only where it divides (long_500k has batch 1)
        return _entry(ba) if size % ba_size == 0 else None

    def leaf_spec(p, shape):
        nd = len(shape)
        if p.startswith("cache/"):
            return _cache_spec(cfg, p, shape, mesh)
        if p in ("tokens", "targets"):
            return (bspec(shape[0]), None)
        if p == "positions":
            return (bspec(shape[0]),)
        if p.endswith("embeds") and nd == 3:
            return (bspec(shape[0]), None, None)
        return (None,) * nd

    return {p: leaf_spec(p, tuple(leaf.shape)) for p, leaf in tree_keys(specs).items()}


def cache_shardings(cfg, shapes, mesh, device):
    """A zero cache of the tree ``shapes`` (meta tensors, ``cache_specs``)
    as DTensors on ``mesh`` placed by :func:`_cache_spec`: each rank
    allocates only its own piece, on ``device`` (the meta device too). Not
    DTensor's ``zeros``, which allocates on the mesh's device type, real
    memory on the dry run's fake CPU mesh."""
    from torch.distributed.tensor import DTensor

    specs = {p: _cache_spec(cfg, f"cache/{p}", tuple(t.shape), mesh)
             for p, t in tree_keys(shapes).items()}

    def zero(d):
        local = torch.zeros(d.to_local().shape, dtype=d.dtype, device=device)
        return DTensor.from_local(local, mesh, d.placements, run_check=False,
                                  shape=d.shape, stride=d.stride())

    return tree_map(zero, place(shapes, specs, mesh))


def _cache_spec(cfg, path: str, shape, mesh) -> tuple:
    """KV and state caches: the batch over data (and pod); the heads over
    model where they divide it, else the sequence axis (distributed-KV
    decode)."""
    ba = batch_axes(mesh)
    sizes = mesh_sizes(mesh)
    ba_size = math.prod(sizes[a] for a in ba)
    if len(shape) >= 2 and shape[1] % ba_size != 0:
        ba = None  # the batch does not divide (long_500k's batch of 1)
    ba = _entry(ba)
    tp = sizes["model"]
    nd = len(shape)
    # the stacked layer dimension first, then the batch
    if re.search(r"/(k|v|ck|cv)$", path) and nd == 5:   # (L, B, W, G, hd)
        if shape[3] % tp == 0:
            return (None, ba, None, "model", None)
        if shape[2] % tp == 0:
            return (None, ba, "model", None, None)
        return (None, ba, None, None, None)
    if re.search(r"/(c|r)$", path) and nd == 4:          # (L, B, S, L_lat)
        if shape[2] % tp == 0:
            return (None, ba, "model", None)
        return (None, ba, None, None)
    if re.search(r"/state$", path) and nd == 5:          # (L, B, nh, P, N)
        return (None, ba, "model" if shape[2] % tp == 0 else None, None, None)
    if re.search(r"/h$", path) and nd == 3:              # (L, B, R)
        return (None, ba, "model" if shape[2] % tp == 0 else None)
    if re.search(r"/conv$", path) and nd == 4:           # (L, B, K-1, C)
        return (None, ba, None, "model" if shape[3] % tp == 0 else None)
    return (None,) * nd

