"""The closed loop: one client runs k-fold cross-validated paths back to
back, each path one ``svm_path`` call of the port on one training fold.

The traffic file gives the loop (``folds``), the grid (``n_lambdas``
values, geometric, from each fold's ``lambda_max`` down to
``lam_min_ratio`` of it), the stop rule (``tol``, ``max_iters``) and the
rest of the call (``call``: ``engine``, ``rules``, ``reduce``), and the
pool of folds the window solves (``pool_rounds`` rounds split from
``pool_seed``; :mod:`svmbench.harness.cv`). The window runs whole cycles
of the pool until ``seconds`` have passed: the cycle in flight then is
finished and counted, so every window solves each path of the pool the
same number of times. A traced run (``--trace 1``) first runs one cycle
under the profiler, then the timed cycles.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from svmbench.harness import cv

#: the harness's host spans around the calls into each layer
FOLD_SPAN, PATH_SPAN = "svmbench.fold", "svmbench.path"
#: the port's own ``record_function`` regions (its host engine's steps)
PORT_SPANS = ("path.step", "path.screen", "path.solve", "path.certify")


@dataclass
class Run:
    """What the metric readers read."""
    m: int
    n: int                 # samples of a training fold
    elem_bytes: int
    setup_s: float = 0.0
    window_s: float = 0.0
    records: list = field(default_factory=list)   # finished paths, in order
    attempted: int = 0
    failed: int = 0
    peak_window_bytes: int | None = None
    trace: object = None                          # profile.TraceSummary
    traced: int = 0        # the first ``traced`` records ran under the profiler

    def untraced(self) -> list:
        """The records of the timed cycles, run without the profiler."""
        return self.records[self.traced:]


def path_call(traffic: dict, device: str):
    """``f(X, y) -> PathResult``: the port's ``svm_path`` as the traffic
    calls it."""
    from repro_torch.core.path import svm_path

    kw = dict(n_lambdas=int(traffic["n_lambdas"]),
              lam_min_ratio=float(traffic["lam_min_ratio"]),
              tol=float(traffic["tol"]), max_iters=int(traffic["max_iters"]),
              device=device, **traffic["call"])
    return lambda X, y: svm_path(X, y, **kw)


def record(res, round_: int, fold: int, wall_s: float) -> dict:
    """The host copy of one path's result that the check and the metrics
    read."""
    ex = res.extras
    solve = ex["solve_times"] if "solve_times" in ex else ex["solve_seconds"]
    return {
        "round": round_, "fold": fold, "wall_s": wall_s,
        "lambdas": res.lambdas, "weights": res.weights, "biases": res.biases,
        "objectives": res.objectives, "keep_masks": ex["keep_masks"],
        "sample_masks": ex.get("sample_masks", {}),
        "deltas": np.array([s.delta for s in ex["path_trace"].steps], np.float64),
        "lam_max": float(ex["lam_max"]),
        "iters": np.asarray(res.solver_iters), "kept": np.asarray(res.kept),
        "kept_samples": np.asarray(res.kept_samples),
        "solve_s": float(np.sum(solve)),
        "captures": int(ex.get("graphs", {}).get("captures", 0)),
    }


def sync(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def one_path(call, feed, round_: int, fold: int, on_card: bool):
    """Runs one path; returns its record, or None when it raised."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(FOLD_SPAN):
        Xf, yf = feed.load(round_, fold)
    try:
        with torch.profiler.record_function(PATH_SPAN):
            res = call(Xf, yf)
    except Exception:  # a failed path is counted, and fails the run
        traceback.print_exc()
        return None
    sync(on_card)
    return record(res, round_, fold, time.perf_counter() - t0)


def _cycle(call, feed, jobs: list, seed: int, cycle: int, on_card: bool,
           run: Run) -> None:
    for round_, fold in cv.cycle_order(jobs, seed, cycle):
        rec = one_path(call, feed, round_, fold, on_card)
        run.attempted += 1
        if rec is None:
            run.failed += 1
        else:
            run.records.append(rec)


def window(call, feed, jobs: list, seed: int, seconds: float, on_card: bool,
           run: Run, profiler=None) -> None:
    """Runs whole cycles of ``jobs`` until ``seconds`` have passed, into
    ``run``. With ``profiler``, one cycle runs inside it first, and the
    timed cycles follow."""
    from svmbench.harness.profile import WINDOW

    cycle = 0
    if profiler is not None:
        with profiler, torch.profiler.record_function(WINDOW):
            _cycle(call, feed, jobs, seed, cycle, on_card, run)
        run.traced = len(run.records)
        cycle += 1
    t0 = time.perf_counter()
    while True:
        _cycle(call, feed, jobs, seed, cycle, on_card, run)
        cycle += 1
        t_end = time.perf_counter()
        if t_end - t0 >= seconds:
            break
    run.window_s = t_end - t0
