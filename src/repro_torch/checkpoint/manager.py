"""Fault-tolerant checkpointing (port of the reference
``checkpoint/manager.py``, on torch tensors and numpy, with no JAX).

The same on-disk format as the reference, so either package's
:meth:`CheckpointManager.restore_raw` reads the other's checkpoints:

* ATOMIC: a step is written to ``step_<k>.tmp`` and published with
  ``os.replace`` — a preemption mid-save never corrupts the latest
  checkpoint.
* ELASTIC: arrays are stored whole (an npz of the flattened state, keys
  the tree paths joined by ``||``), so a restart may use another grid: a
  sharded path writes its gathered state and every rank takes its own
  block back.
* SELF-DESCRIBING: ``manifest.json`` carries the step, the time, the
  format and the caller's ``extra`` (JSON).
* KEEP-K + corruption fallback: ``latest()`` validates the manifest and
  falls back to an older checkpoint when the newest is unreadable.

A state is a tree of dicts, lists and tuples whose leaves are tensors,
numpy arrays or numbers (``None`` leaves are skipped). Tensors are copied
to the host before they are written; :func:`load_pytree` puts a tensor
leaf back on its template's device and dtype. A bf16 tensor, which numpy
cannot hold, is written losslessly as its raw 2-byte values (``|V2``, the
bytes the reference's ``save`` writes for a bf16 leaf) and restored bit for
bit (or cast to a template of another dtype); the reference's own
``restore`` refuses that format (``No cast function available``).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]

_SEP = "||"


def _leaves_with_path(tree, prefix=()):
    """``(path, leaf)`` pairs in the reference's order: dict keys sorted,
    sequences by index."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, prefix + (str(i),))
    else:
        yield prefix, tree


#: numpy has no bfloat16: a bf16 leaf is stored as its raw 2-byte values,
#: the bytes and dtype (``|V2``) the reference writes for one
_BF16_DISK = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_DISK)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_SEP.join(p): _to_numpy(leaf) for p, leaf in _leaves_with_path(tree)}


def save_pytree(tree, path: Path):
    np.savez(path, **_flatten(tree))


def _restore_leaf(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        if arr.dtype == _BF16_DISK:  # a bf16 leaf's bits, either package's
            t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    if hasattr(leaf, "dtype"):
        return arr.astype(leaf.dtype)
    return arr


def load_pytree(template, path: Path, strict: bool = True):
    """Restore into the structure of ``template`` (values replaced, each
    cast to its template leaf's dtype; a tensor leaf comes back on its
    template's device; a NamedTuple keeps its type).

    ``strict=False`` lets state schemas evolve: template leaves missing from
    the checkpoint keep their template (initial) value instead of raising.
    """
    with np.load(path, allow_pickle=False) as data:
        flat = {k: np.array(v) for k, v in data.items()}

    def rebuild(tree, prefix):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: rebuild(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [rebuild(v, prefix + (str(i),)) for i, v in enumerate(tree)]
            if hasattr(tree, "_fields"):  # a NamedTuple (a TrainState) keeps its type
                return type(tree)(*out)
            return type(tree)(out) if isinstance(tree, list) else tuple(out)
        key = _SEP.join(prefix)
        if not strict and key not in flat:
            return tree
        return _restore_leaf(flat[key], tree)

    return rebuild(template, ())


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- write ----------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        tmp = self.dir / f"step_{step:012d}.tmp"
        final = self.dir / f"step_{step:012d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        save_pytree(state, tmp / "state.npz")
        manifest = {
            "step": step,
            "time": time.time(),
            "format": 1,
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():  # a re-run of the same step replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        ckpts = self.all_steps()
        for step in ckpts[: -self.keep] if len(ckpts) > self.keep else []:
            shutil.rmtree(self.dir / f"step_{step:012d}", ignore_errors=True)

    # -- read -----------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not p.is_dir():
                continue
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(steps)

    def latest(self) -> Optional[int]:
        for step in reversed(self.all_steps()):
            if self._valid(step):
                return step
        return None

    def _valid(self, step: int) -> bool:
        d = self.dir / f"step_{step:012d}"
        try:
            m = json.loads((d / "manifest.json").read_text())
            return m.get("step") == step and (d / "state.npz").exists()
        except Exception:
            return False

    def restore(self, step: int, template: Any, strict: bool = True):
        d = self.dir / f"step_{step:012d}"
        state = load_pytree(template, d / "state.npz", strict=strict)
        manifest = json.loads((d / "manifest.json").read_text())
        return state, manifest

    def restore_raw(self, step: int) -> tuple[dict, dict]:
        """Template-free restore: the checkpoint's flattened ``{path:
        array}`` dict plus its manifest."""
        d = self.dir / f"step_{step:012d}"
        with np.load(d / "state.npz", allow_pickle=False) as data:
            flat = {k: np.array(v) for k, v in data.items()}
        manifest = json.loads((d / "manifest.json").read_text())
        return flat, manifest
