"""One run of one cell of the benchmark of ``repro_torch``, the PyTorch and
CUDA port of the sparse-SVM screening library.

    python3 svmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: ``BENCHMARK.json`` names the cell's
configuration and traffic, whose files under ``svmbench/`` say what data
to make (on the card, from ``--seed``) and how to call the port. Set-up
builds and loads the port's kernels, makes the data, and runs the
traffic's warm-up paths; the window then runs whole cross-validated paths
for ``--seconds`` (:mod:`svmbench.harness.loop`). Once the window has
closed, one more path runs on a fold that ``--seed`` draws, and it and
every path the window finished are judged against the float64 reference
(:mod:`svmbench.harness.check`). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics,
from one cycle of the pool under a profiler before the timed window),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit, which also close standard error.

Exits 2 without a result where CUDA is not available or the card count is
below the cell's, and 3 where ``jax``, ``jaxlib``, ``flax`` or ``repro``
(the JAX package) is loaded once the window has closed.

``--device cpu`` runs the port's plain versions on the CPU for the
harness's own tests: nothing it prints is a device measurement.
``--control bf16`` hands the port each fold's X rounded to bfloat16, the
lower-precision control that the limits must reject.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

#: top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--control", choices=("none", "bf16"), default="none")
    return p.parse_args(argv)


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from svmbench.harness import check, cv, loop, profile, spec

    cell = spec.resolve(ROOT, args.workload)
    on_card = args.device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        print(f"svmbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    traffic = cell.traffic
    call = loop.path_call(traffic, args.device)
    if args.control == "bf16":
        full = call
        call = lambda X, y: full(X.to(torch.bfloat16).to(X.dtype), y)  # noqa: E731

    t_data = time.perf_counter()
    # a configuration is one dataset, as a published one is
    X, y = cell.generator().make(cell.config, cell.config["data_seed"], args.device)
    k = int(traffic["folds"])
    feed = cv.FoldFeed(X, y, k, int(traffic["pool_seed"]))
    loop.sync(on_card)
    t_warm = time.perf_counter()
    for w in range(int(traffic["warm_paths"])):
        if loop.one_path(call, feed, -1 - w // k, w % k, on_card) is None:
            print("svmbench: a warm-up path raised", file=sys.stderr)
            return 1
    run = loop.Run(m=X.shape[0], n=feed.Xf.shape[1], elem_bytes=X.element_size())
    setup_peak = 0
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - T_START
    print(f"setup: {t_data - T_START:.3f} s to the data (imports, CUDA context), "
          f"{t_warm - t_data:.3f} s making it, {T_START + run.setup_s - t_warm:.3f} s "
          "warming up (the kernels' build or load, the warm paths)", file=sys.stderr)

    prof = None
    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    loop.window(call, feed, cv.pool(int(traffic["pool_rounds"]), k), args.seed,
                args.seconds, on_card, run, prof)
    print(f"window: {run.attempted} paths in {run.window_s:.3f} s, "
          f"{sum(r['captures'] for r in run.records)} graph captures; walls "
          f"{[round(r['wall_s'], 3) for r in run.records]}, iterations "
          f"{[int(r['iters'].sum()) for r in run.records]}", file=sys.stderr)
    peak = 0
    if on_card:
        run.peak_window_bytes = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, run.peak_window_bytes)
    if prof is not None:
        run.trace = profile.summarize(
            profile.events(prof), {profile.WINDOW, loop.FOLD_SPAN, loop.PATH_SPAN,
                                   *loop.PORT_SPANS})
        del prof

    # the pool is the same in every run: what the seed adds to the check is
    # one more path by the same call, on a fold of a round of its own, solved
    # once the window has closed and judged with the window's
    fresh = loop.one_path(call, feed, *cv.fresh_fold(args.seed, k), on_card)
    judged = run.records + ([fresh] if fresh is not None else [])

    # the port's warm state goes before the reference runs
    from repro_torch.core.path_scan import clear_engine_cache

    clear_engine_cache()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    worst = check.readings(feed, judged)
    print(f"check: {len(judged)} paths judged in "
          f"{time.perf_counter() - t_check:.3f} s (the fresh fold's "
          f"{'raised' if fresh is None else 'included'})", file=sys.stderr)
    correct, compared = check.verdict(worst, traffic["limits"],
                                      run.failed + (fresh is None))

    found = forbidden_modules()
    if found:
        print(f"svmbench: loaded after the window: {found}", file=sys.stderr)
        return 3

    metrics = {}
    for mt in (cell.per_layer if args.trace else cell.end_to_end):
        v = mt.reader.read(run)
        if v is not None:
            metrics[mt.name] = {"value": v, "unit": mt.unit}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name() if on_card else "cpu",
              "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = {name: {"value": _finite(c["value"]), "limit": c["limit"]}
                     for name, c in compared.items()}
    for name, v in worst.items():
        if name not in compared:
            print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
