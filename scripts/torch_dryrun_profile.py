"""Where one dry-run step's time goes: DTensor's sharding propagation.

    PYTHONPATH=src python scripts/torch_dryrun_profile.py ARCH SHAPE {single,multi}
        [--cprofile OUT.prof]

Builds the cell of ``repro_torch.launch.dryrun`` (production configuration,
meta shards on the fake process group) and runs its step once, with
DTensor's ``ShardingPropagator`` wrapped so that every uncached call (one a
distinct operator, shapes and placements signature) is counted and timed,
and the redistribute planner (``_gen_transform_infos_non_cached``) and its
cost function (``redistribute_cost``) timed. Prints one JSON line: the
step's wall, its error if any, the signatures planned and their seconds by
operator (the slowest ones whole), the planner's calls and seconds, and the
collectives the step counted. ``--cprofile`` also profiles the step
(cProfile, to OUT.prof; its cumulative times miss the calls that enter from
DTensor's C++ dispatch, so read its own-time and call counts). The step
runs under the dry run's own budget, ``dryrun.STEP_BUDGET_S``.

It patches DTensor internals as torch 2.13 names them
(``ShardingPropagator.propagate_op_sharding_non_cached``,
``_redistribute._gen_transform_infos_non_cached``, ``redistribute_cost``
in ``_ops.utils`` and ``_utils``); another torch may rename or move them.
A CPU program: its seconds are this CPU's, no device's.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("mesh", choices=["single", "multi"])
    ap.add_argument("--cprofile", default=None)
    args = ap.parse_args(argv)

    import torch.distributed.tensor._collective_utils as collective_utils
    import torch.distributed.tensor._ops.utils as op_utils
    import torch.distributed.tensor._redistribute as redistribute
    import torch.distributed.tensor._utils as tensor_utils
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import LocalLRUCache

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PRODUCTION, fake_world, make_production_mesh

    prop = DTensor._op_dispatcher.sharding_propagator
    plan = prop.propagate_op_sharding_non_cached
    by_op = collections.defaultdict(lambda: [0, 0.0])   # signatures, seconds (outermost)
    slow, depth = [], [0]

    def planned(schema):
        t0 = time.perf_counter()
        depth[0] += 1
        try:
            return plan(schema)
        finally:
            depth[0] -= 1
            dt = time.perf_counter() - t0
            rec = by_op[str(schema.op)]
            rec[0] += 1
            if depth[0] == 0:
                rec[1] += dt
                if dt > 1.0:
                    slow.append((round(dt, 3), str(schema)[:400]))

    # the C++ dispatch calls the uncached method on a cache miss, Python the cached one
    prop.propagate_op_sharding_non_cached = planned
    prop.propagate_op_sharding = LocalLRUCache(planned)

    def timing(fn, acc):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[0] += 1
                acc[1] += time.perf_counter() - t0
        return wrapped

    plans, costs = [0, 0.0], [0, 0.0]
    redistribute._gen_transform_infos_non_cached = timing(
        redistribute._gen_transform_infos_non_cached, plans)
    cost = timing(collective_utils.redistribute_cost, costs)
    op_utils.redistribute_cost = tensor_utils.redistribute_cost = cost

    multi = args.mesh == "multi"
    cfg = dryrun.cell_config(args.arch, args.shape)
    profiler = None
    if args.cprofile:
        import cProfile
        profiler = cProfile.Profile()
    with fake_world(math.prod(PRODUCTION[multi][0])):
        mesh = make_production_mesh(multi_pod=multi)
        cell = dryrun.build_cell(cfg, args.shape, mesh)
        step = cell.step
        if profiler is not None:
            def step(a, _step=cell.step):
                profiler.enable()
                try:
                    return _step(a)
                finally:
                    profiler.disable()
        t0 = time.perf_counter()
        traced = dryrun.trace_step(cell._replace(step=step), mesh)
        wall = time.perf_counter() - t0
    if profiler is not None:
        profiler.dump_stats(args.cprofile)
    print(json.dumps({
        "arch": args.arch, "shape": args.shape, "mesh": dryrun.MESH_NAMES[multi],
        "wall_s": wall, "step_error": traced.get("step_error"),
        "signatures": sum(v[0] for v in by_op.values()),
        "propagation_s": sum(v[1] for v in by_op.values()),
        "redistribute_plans": plans[0], "redistribute_plan_s": plans[1],
        "redistribute_cost_calls": costs[0], "redistribute_cost_s": costs[1],
        "by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1][1])[:12]),
        "slowest": sorted(slow, reverse=True)[:6],
        "collectives": traced.get("collectives"), "axes": traced.get("axes")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
