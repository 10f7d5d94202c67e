"""Fault injection for the robustness tests (port of the reference
``testing/faults.py``).

Each injector targets one seam the production code exposes on purpose:

* :func:`poison_path_step` — ``PathDriver._fault_injector``: corrupt the
  accepted solution of path step ``k`` *before* it is recorded and
  certified, so the poison flows into the step's stored weights, the next
  anchor's certificate and the next warm start. The recovery chain
  (refused certificate → keep-all screen → sanitized warm start) is what
  the tests then assert on.
* :func:`poison_stream_iterate` — ``fista_solve_chunked(iteration_hook=)``:
  corrupt the streamed solver's candidate at host-loop iteration ``k``,
  exercising its guard (rollback and step backoff).
* :func:`corrupt_store_bytes` / :func:`truncate_store_file` — flip payload
  bytes of (or truncate) an on-disk store file, for the checksum and
  truncation checks.
* :func:`flaky_reads` / :func:`dead_reads` — context managers installing
  ``repro_torch.sparse.chunked._read_fault_hook`` so guarded store reads
  fail transiently (absorbed by the retry) or persistently (a typed
  ``StoreError``).
* :func:`kill_server_after` — ``PathServer._step_hook``: raise
  :class:`ServerKilled` after N serve-loop steps, a crash mid-drain (the
  snapshots taken before it stay valid: each is published atomically).
* :func:`poison_server_slot` — ``PathServer._fault_injector``: make a
  slot's step outputs non-finite before the server's host check. The
  reference poisons a slot's carried bias instead, with its solver guard
  switched off; the port's guard is always on and heals such a carry inside
  the next solve, so the poison goes where the host check reads it.

Nothing here is imported by production code; the seams default to off
(``None`` hooks).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..sparse import chunked as _chunked

__all__ = ["ServerKilled", "poison_path_step", "poison_stream_iterate",
           "corrupt_store_bytes", "truncate_store_file", "flaky_reads",
           "dead_reads", "kill_server_after", "poison_server_slot"]


class ServerKilled(RuntimeError):
    """Raised by :func:`kill_server_after` to simulate a server crash."""


# -- solver / path poison ----------------------------------------------------

def poison_path_step(k: int, value: float = np.nan, coord: int = 0):
    """A ``PathDriver._fault_injector`` that corrupts step ``k``'s accepted
    weights (``w[coord] = value``, on a copy) and bias, exactly once. The
    driver passes ``w`` as a tensor on its device (a numpy array works
    too) and ``b`` as a float."""
    state = {"fired": False}

    def injector(step, w_full, b_new):
        if step == k and not state["fired"]:
            state["fired"] = True
            w_full = (w_full.clone() if isinstance(w_full, torch.Tensor)
                      else np.array(w_full, copy=True))
            w_full[coord] = value
            return w_full, float(value)
        return w_full, b_new

    injector.state = state
    return injector


def poison_stream_iterate(k: int, value: float = np.nan):
    """An ``iteration_hook`` for ``fista_solve_chunked`` that replaces the
    candidate objective at host iteration ``k`` with ``value``, once."""
    state = {"fired": False}

    def hook(step, w, b, u, obj):
        if step == k and not state["fired"]:
            state["fired"] = True
            return w, b, u, np.float32(value)
        return None

    hook.state = state
    return hook


# -- storage faults ----------------------------------------------------------

def corrupt_store_bytes(path, offset: int = 0, nbytes: int = 4):
    """Flip ``nbytes`` payload bytes of a store file in place (XOR 0xFF —
    always a change, hence a different crc32)."""
    with open(path, "r+b") as f:
        f.seek(offset)
        raw = f.read(nbytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in raw))


def truncate_store_file(path, nbytes: int = 0):
    """Truncate a store file to ``nbytes`` (an interrupted write that
    escaped the build protocol, or filesystem damage)."""
    with open(path, "r+b") as f:
        f.truncate(nbytes)


@contextlib.contextmanager
def flaky_reads(n_failures: int = 1):
    """Guarded store reads raise a transient ``OSError`` for their first
    ``n_failures`` attempts, then succeed; the retry loop must absorb them
    (the yielded dict counts the injected failures per read)."""
    counts: dict = {}

    def hook(tag, attempt):
        seen = counts.setdefault(tag, 0)
        if seen < n_failures:
            counts[tag] = seen + 1
            raise OSError(f"injected transient fault on {tag}")

    prev = _chunked._read_fault_hook
    _chunked._read_fault_hook = hook
    try:
        yield counts
    finally:
        _chunked._read_fault_hook = prev


@contextlib.contextmanager
def dead_reads():
    """Every guarded store read fails persistently: the retries run out and
    a typed ``StoreError`` surfaces."""

    def hook(tag, attempt):
        raise OSError(f"injected persistent fault on {tag}")

    prev = _chunked._read_fault_hook
    _chunked._read_fault_hook = hook
    try:
        yield
    finally:
        _chunked._read_fault_hook = prev


# -- the path server -----------------------------------------------------------

def kill_server_after(n_steps: int):
    """A ``PathServer._step_hook`` raising :class:`ServerKilled` once the
    serve loop has run ``n_steps`` batched steps."""

    def hook(step_count):
        if step_count >= n_steps:
            raise ServerKilled(f"injected crash after {step_count} steps")

    return hook


def poison_server_slot(slot: int = 0, at_step: int = 1, times: int = 1,
                       value: float = np.nan):
    """A ``PathServer._fault_injector`` that replaces slot ``slot``'s step
    objective and weights with ``value`` in the first ``times`` serve steps
    from step ``at_step`` on (counted from 1) in which the slot is live."""
    state = {"fired": 0}

    def injector(step, s, out):
        if s == slot and step >= at_step and state["fired"] < times:
            state["fired"] += 1
            out = dict(out, obj=np.float32(value), w=np.full_like(out["w"], value))
        return out

    injector.state = state
    return injector
