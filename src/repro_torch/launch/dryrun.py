"""Multi-pod dry run: every (arch x shape x mesh) cell's placements on the
reference's production meshes, each rank's argument bytes, and one traced
step where DTensor runs it (``repro.launch.dryrun``'s counterpart).

There is no XLA to lower to. Per cell the parameters, the AdamW state
(train cells), the inputs and the cache are DTensors whose local shards
are meta tensors: shape and dtype, no storage, made from the meta shapes of
``transformer.meta_params`` and ``config.input_specs``, never from
``init_params``. They are placed by the rules of ``models.sharding`` on a
mesh over the fake process group (``launch.mesh.fake_world``), which has
512 ranks in name only. (Fake tensors under ``FakeTensorMode`` would do
too, but DTensor's strided-shard planning calls ``tolist`` on a tensor it
makes, which fake mode refuses; meta shards carry the same shapes.)

* Bytes, every cell: each rank's arguments, the sum of ``to_local()``
  sizes, by group (``params``, ``opt``, ``inputs``, ``cache``).
* Steps, where they run: under the ambient mesh (``sharding.set_mesh``)
  and ``implicit_replication`` (the models' plain index tensors count as
  replicated), one step of the port's own functions: a train cell the
  train step's two halves without its host fetch (``make_train_step``'s
  ``device_step`` and ``update``), a prefill cell ``transformer.prefill``,
  a decode cell ``make_serve_step``. A ``CommDebugMode`` counts the
  collectives under the reference's five names with the bytes of each
  result shape, and each rank's flops (:func:`step_counter`). The fake
  group runs no collective and a meta shard no arithmetic, so a step costs
  only DTensor's dispatch and planning (minutes for a full-width train or
  prefill cell; on the (2, 16, 16) mesh DTensor's placement search can
  take minutes an operation, and a step past :data:`STEP_BUDGET_S` is given
  up). A step that does not run leaves ``"collectives": null`` and a
  ``"step_error"`` naming the op and the port's ``file:line``.

Records keep the reference's keys where they mean the same thing; a key
with no torch counterpart (``bytes_accessed``, XLA's output, temp, code and
alias sizes, the HLO op count, lower and compile seconds) is null and
listed under ``"unavailable"``. The HLO parser (``hlo_analysis``) has no
counterpart: no torch path emits HLO, and the collectives come from the
dispatched step instead. The meshes are the reference's shapes, kept so
that the placements compare; the records state no time of any machine.

Run it as ``python -m repro_torch.launch.dryrun [--arch A] [--shape S]
[--mesh single|multi|both] [--out artifacts/dryrun] [--force]
[--cost-mode] [--baseline]``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import signal
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Callable, NamedTuple

import torch

from ..configs import ARCHS, SHAPES, get_config
from ..models import sharding
from ..models import transformer as tr
from ..models.config import cell_inputs
from ..optim.adamw import AdamWState
from ..tree import leaves, tree_map_with_path
from .mesh import PRODUCTION, fake_world, make_production_mesh
from .steps import TrainState, make_serve_step, make_train_step

#: the reference's collective names, in its order
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
#: reference record keys that have no torch counterpart (null in a record)
UNAVAILABLE = ("bytes_accessed", "memory.output_size_in_bytes", "memory.temp_size_in_bytes",
               "memory.generated_code_size_in_bytes", "memory.alias_size_in_bytes",
               "hlo_ops", "lower_s", "compile_s")
MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}
#: seconds a traced step may take before its record gives it up
STEP_BUDGET_S = 600.0


class Cell(NamedTuple):
    args: dict          # {"params", "opt", "inputs", "cache"}: DTensor trees or None
    step: Callable      # runs the cell's step on ``args``


def _collective_names() -> dict:
    """The functional collectives DTensor issues -> the reference's names."""
    ops = torch.ops._c10d_functional
    return {ops.all_reduce: "all-reduce", ops.all_reduce_coalesced: "all-reduce",
            ops.all_gather_into_tensor: "all-gather",
            ops.all_gather_into_tensor_coalesced: "all-gather",
            ops.reduce_scatter_tensor: "reduce-scatter",
            ops.reduce_scatter_tensor_coalesced: "reduce-scatter",
            ops.all_to_all_single: "all-to-all"}


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


def step_counter(mesh=None):
    """A ``CommDebugMode`` that keeps ``stats``, ``{name: {"count",
    "bytes"}}`` under :data:`COLLECTIVES` (the bytes of each collective's
    result: the reference's ``collective_stats`` record; a collective of
    another kind under its own op name), ``comm_counts`` as
    ``CommDebugMode.get_comm_counts`` reads them, ``flops``, each rank's,
    and ``axes``, ``{axis: {name: count}}`` by the ``mesh`` axis whose
    group ran the collective (empty without a ``mesh``). As
    ``CommDebugMode`` does, it lets DTensor dispatch first and sees the
    local operations and collectives that DTensor issues; it
    counts the flops of those by ``FlopCounterMode``'s per-operator
    formulas (``FlopCounterMode`` itself sees each DTensor operation at its
    global shapes). It keeps no per-operation log: ``CommDebugMode``'s own
    dispatch records every DTensor operation's input shapes and placements,
    gigabytes over a full-width step."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import flop_registry

    names = _collective_names()
    groups = {}
    if mesh is not None:
        for axis in mesh.mesh_dim_names:
            groups[mesh.get_group(axis).group_name] = axis

    class StepCounter(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.stats = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
            self.flops = 0
            self.axes = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **kwargs)
            if any(t is DTensor for t in types):
                return NotImplemented  # DTensor runs, then its local operations come here
            out = func(*args, **kwargs)
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            if packet in names or packet in self.comm_registry:
                self.comm_counts[packet] += 1
                rec = self.stats.setdefault(names.get(packet, str(packet)),
                                            {"count": 0, "bytes": 0})
                rec["count"] += 1
                rec["bytes"] += _nbytes(out)
                axis = _group_axis(args, groups)
                if axis is not None:
                    by = self.axes.setdefault(axis, {})
                    name = names.get(packet, str(packet))
                    by[name] = by.get(name, 0) + 1
            return out

    return StepCounter()


def _group_axis(args, groups: dict):
    """The mesh axis of a functional collective's group (its last string
    argument is the group's name), or None for a group of no one axis."""
    return groups.get(next((a for a in reversed(args) if isinstance(a, str)), None))


# ---------------------------------------------------------------------------
# building a cell
# ---------------------------------------------------------------------------

def train_state_arguments(cfg, mesh, moment_dtype=torch.float32) -> TrainState:
    """The train state of ``cfg`` placed on ``mesh`` as the reference's
    ``build_cell`` places it: parameters and both moments by the parameter
    rules, the step replicated; meta shards."""
    meta = tr.meta_params(cfg)
    specs = sharding.param_specs(meta, mesh)
    moments = tree_map_with_path(
        lambda p, t: torch.empty(t.shape, dtype=moment_dtype, device="meta"), meta)
    step = sharding.place(torch.zeros((), dtype=torch.int32, device="meta"), {"": ()}, mesh)
    return TrainState(params=sharding.place(meta, specs, mesh),
                      opt=AdamWState(step=step, mu=sharding.place(moments, specs, mesh),
                                     nu=sharding.place(moments, specs, mesh)))


def build(cfg, kind: str, batch: int, seq: int, mesh) -> Cell:
    """A ``kind`` cell of ``batch`` x ``seq`` (a decode cell: its cache's
    length) on ``mesh``."""
    specs = cell_inputs(cfg, kind, batch, seq)
    in_specs = sharding.input_sharding_specs(cfg, specs, mesh)
    cache = specs.pop("cache", None)
    inputs = sharding.place(specs, in_specs, mesh)
    if kind == "train":
        state = train_state_arguments(cfg, mesh)
        step_fn = make_train_step(cfg)

        def train(args):
            st = TrainState(args["params"], args["opt"])
            _, _, grads, lr, gn = step_fn.device_step(st, args["inputs"])
            return step_fn.update(st, grads, lr, gn)
        return Cell({"params": state.params, "opt": state.opt, "inputs": inputs,
                     "cache": None}, train)

    meta = tr.meta_params(cfg)
    params = sharding.place(meta, sharding.param_specs(meta, mesh), mesh)
    if kind == "prefill":
        return Cell({"params": params, "opt": None, "inputs": inputs, "cache": None},
                    lambda a: tr.prefill(a["params"], cfg, a["inputs"], max_seq=seq))
    serve = make_serve_step(cfg)
    return Cell({"params": params, "opt": None, "inputs": inputs,
                 "cache": sharding.place(cache, in_specs, mesh, "cache/")},
                lambda a: serve(a["params"], a["cache"], a["inputs"]["tokens"],
                                a["inputs"]["positions"]))


def build_cell(cfg, shape_name: str, mesh) -> Cell:
    """The cell of a ``SHAPES`` entry."""
    sh = SHAPES[shape_name]
    return build(cfg, sh["kind"], sh["batch"], sh["seq"], mesh)


def local_bytes(tree) -> int:
    """A rank's bytes of a tree of DTensors: the sum of its local shards."""
    if tree is None:
        return 0
    return sum(t.to_local().numel() * t.element_size() for t in leaves(tree))


def argument_bytes(cell: Cell) -> dict:
    """``{group: bytes}`` of one rank's arguments."""
    return {g: local_bytes(t) for g, t in cell.args.items()}


def _where(exc: BaseException) -> str:
    """``error: op at file:line (code)``: the exception's line that names an
    aten op (else its first line), and the innermost frame of the port's
    step that raised it (the budget's handler aside), with its source line.
    A budget that ran out while DTensor planned an operation (which wraps
    the error as a failed sharding propagation) is named as the budget."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename and f.filename != __file__]
    at = ""
    if frames:
        f = frames[-1]
        at = f" at {f.filename[f.filename.rfind('repro_torch'):]}:{f.lineno} ({f.line})"
    lines = str(exc).strip().splitlines()
    named = [ln for ln in lines if "aten." in ln]
    head = (named[-1] if named else lines[0] if lines else "")[:300]
    name = type(exc).__name__
    cause = exc
    while cause is not None and not isinstance(cause, StepBudgetExceeded):
        cause = cause.__cause__ or cause.__context__
    if cause is not None and cause is not exc:
        op = re.search(r"aten\.[\w.]+", head)
        name = type(cause).__name__
        head = f"{cause} while DTensor planned {op.group(0) if op else 'an operation'}"
    return f"{name}: {head}{at}"


class StepBudgetExceeded(RuntimeError):
    pass


@contextlib.contextmanager
def _budget(seconds: float):
    """Raise :class:`StepBudgetExceeded` in the block after ``seconds`` (a
    ``SIGALRM`` timer; in the main thread only, elsewhere no limit)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        raise StepBudgetExceeded(f"the step ran past its {seconds:g} s budget")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def trace_step(cell: Cell, mesh, ambient: bool = True) -> dict:
    """Runs the cell's step once; ``{"collectives", "collective_bytes_total",
    "flops", "step_s"}``, or ``{"collectives": None, "step_error": ...}``
    (also for a step past :data:`STEP_BUDGET_S` seconds: DTensor plans every
    new operation's placements, which on the 3-D mesh can take minutes an
    operation)."""
    from torch.distributed.tensor.experimental import implicit_replication

    counter = step_counter(mesh)
    t0 = time.perf_counter()
    try:
        with _budget(STEP_BUDGET_S), \
                (sharding.set_mesh(mesh) if ambient else contextlib.nullcontext()), \
                implicit_replication(), counter:
            cell.step(cell.args)
    except Exception as e:  # noqa: BLE001 - the record names what stopped the step
        return {"collectives": None, "collective_bytes_total": None, "flops": None,
                "step_error": _where(e), "step_s": time.perf_counter() - t0}
    stats = counter.stats
    return {"collectives": stats,
            "collective_bytes_total": int(sum(c["bytes"] for c in stats.values())),
            "flops": float(counter.flops), "axes": counter.axes,
            "step_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# cells and the CLI
# ---------------------------------------------------------------------------

def cell_config(arch: str, shape_name: str, cost_mode: bool = False, baseline: bool = False):
    """The reference's configuration of a dry-run cell."""
    cfg = get_config(arch)
    if baseline:
        # the "before" configuration: grouped GQA layout, monolithic CE,
        # float32 MoE combine, 2,048-token dispatch groups
        kw = dict(gqa_grouped=True, loss_chunk=0, moe_combine_f32=True)
        if cfg.moe_num_experts:
            kw["moe_group_size"] = 2048
        cfg = cfg.replace(**kw)
    else:
        cfg = cfg.replace(loss_chunk=512, remat="dots")
    if cost_mode:
        kw = dict(unroll_segments=True, blockwise_q=8192, blockwise_kv=8192)
        if cfg.ssm_state:
            kw["ssm_chunk"] = max(cfg.ssm_chunk, SHAPES[shape_name]["seq"] // 8)
        cfg = cfg.replace(**kw)
    return cfg


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             force: bool = False, cost_mode: bool = False, baseline: bool = False) -> dict:
    """One cell's record, written to ``out_dir`` (an existing record is
    returned as it is unless ``force``)."""
    mesh_name = MESH_NAMES[multi_pod]
    suffix = ("__cost_base" if baseline else "__cost") if cost_mode else (
        "__base" if baseline else "")
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = cell_config(arch, shape_name, cost_mode, baseline)
    skips = cfg.shape_skips()
    if shape_name in skips:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "skipped": skips[shape_name]}
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    shape, _ = PRODUCTION[multi_pod]
    with fake_world(math.prod(shape)):
        t0 = time.perf_counter()
        mesh = make_production_mesh(multi_pod=multi_pod)
        cell = build_cell(cfg, shape_name, mesh)
        groups = argument_bytes(cell)
        build_s = time.perf_counter() - t0
        traced = trace_step(cell, mesh, ambient=not baseline)
        del cell

    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "cost_mode": cost_mode, "baseline": baseline, "devices": math.prod(shape),
        "flops": traced["flops"], "bytes_accessed": None,
        "memory": {"argument_size_in_bytes": sum(groups.values()),
                   "output_size_in_bytes": None, "temp_size_in_bytes": None,
                   "generated_code_size_in_bytes": None, "alias_size_in_bytes": None},
        "argument_bytes": groups,
        "collectives": traced["collectives"],
        "collective_bytes_total": traced["collective_bytes_total"],
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "build_s": build_s, "step_s": traced["step_s"],
        "lower_s": None, "compile_s": None, "hlo_ops": None,
        "unavailable": list(UNAVAILABLE),
    }
    if "step_error" in traced:
        rec["step_error"] = traced["step_error"]
    out_path.write_text(json.dumps(rec, indent=2))
    coll = rec["collective_bytes_total"]
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
          f"args/rank={rec['memory']['argument_size_in_bytes']:.4e} B "
          + (f"flops/rank={rec['flops']:.3e} coll={coll:.3e} B" if coll is not None
             else f"step: {rec['step_error']}"), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--cost-mode", action="store_true",
                    help="the reference's unrolled cost configuration")
    ap.add_argument("--baseline", action="store_true",
                    help="the reference's pre-optimization configuration, no ambient mesh")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape, mp, out_dir, force=args.force,
                             cost_mode=args.cost_mode, baseline=args.baseline)
                except Exception as e:  # noqa: BLE001 - every cell gets its try
                    failures.append((arch, shape, mp, repr(e)))
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells recorded.")


if __name__ == "__main__":
    main(sys.argv[1:])
