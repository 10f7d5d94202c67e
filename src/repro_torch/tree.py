"""The port's one walk of a tree: nested dicts, lists and tuples whose
leaves are tensors (parameters, moments, gradients, a decode cache, a train
state), visited in insertion order."""

from __future__ import annotations

from torch.distributed.tensor import DTensor


def tree_keys(tree, path: str = "") -> dict:
    """A tree's leaves keyed by their paths, ``"segments/0/s0/k"``: the
    port's trees and the reference's alike."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(tree_keys(v, f"{path}/{k}" if path else str(k)))
    return out


def leaves(tree) -> list:
    """A tree's leaves in the order of :func:`tree_keys`."""
    return list(tree_keys(tree).values())


def is_distributed(t) -> bool:
    """Whether ``t`` is a DTensor (a leaf placed on a mesh)."""
    return isinstance(t, DTensor)


def tree_map_with_path(fn, tree, path: str = ""):
    """:func:`tree_map` with ``fn(path, leaf)``, the paths of
    :func:`tree_keys`."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, sub(i)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(tree_map_with_path(fn, v, sub(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each leaf; dicts, lists and tuples
    keep their kind (a named tuple comes back a plain tuple)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)
