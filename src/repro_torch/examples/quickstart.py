"""Quickstart: safe screening for the sparse SVM, the reference's
``examples/quickstart.py`` through the port's API, with its sizes, seeds,
grids and printed lines.

It runs on the card unless ``--device cpu`` is given (then every kernel
runs its plain PyTorch version); without a GPU the default raises:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the screen, margin and gradient kernels run in every path,
and the sample sweep in section 6 (``sample_vi`` and ``composite``). The
scan engine's first call in section 8 is its warm-up: its chunks' CUDA
graphs are captured there (on the CPU they run eagerly). :func:`main`
returns what the sections compared, for a caller to hold to a tolerance.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import (
    PathDriver,
    available_rules,
    fista_solve,
    lambda_max,
    screen,
    svm_path,
)
from ..core.dual import theta_at_lambda_max
from ..data import make_sparse_classification
from ..device import resolve_device
from ..launch.path_server import PathJob, PathServer
from ..sparse import FeatureChunked


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # 1. data: 2000 features x 300 samples, 12 truly-informative features
    ds = make_sparse_classification(m=2000, n=300, k_active=12, seed=0)
    X = torch.as_tensor(ds.X, device=dev)
    y = torch.as_tensor(ds.y, device=dev)

    # 2. lambda_max in closed form (paper Eq. 26): above it, w* = 0
    lmax = float(lambda_max(X, y))
    out["lambda_max"] = lmax
    print(f"lambda_max = {lmax:.3f}")

    # 3. screen features for lambda = 0.7*lmax using the exact dual point at lmax
    #    (screening power grows as lambda2 -> lambda1; the path below shows the
    #    sequential rule staying strong across the whole grid)
    theta1 = theta_at_lambda_max(y, torch.tensor(lmax, device=dev))
    lam2 = 0.7 * lmax
    keep, bounds = screen(X, y, lmax, lam2, theta1)
    out["keep"], out["bounds"] = keep.cpu().numpy(), bounds.cpu().numpy()
    print(f"screening keeps {int(keep.sum())}/{X.shape[0]} features "
          f"(rejected {100 * (1 - float(keep.float().mean())):.1f}%)")

    # 4. solve the reduced problem — same solution, fraction of the work
    idx = torch.nonzero(keep)[:, 0]
    res_red = fista_solve(X[idx], y, lam2, max_iters=20000, tol=1e-10)
    res_full = fista_solve(X, y, lam2, max_iters=20000, tol=1e-10)
    out["obj_reduced"], out["obj_full"] = float(res_red.obj), float(res_full.obj)
    print(f"objective reduced={float(res_red.obj):.6f} full={float(res_full.obj):.6f} "
          f"(identical => screening was safe)")

    # 5. a whole regularization path with sequential screening
    path = svm_path(ds.X, ds.y, n_lambdas=8, lam_min_ratio=0.1, device=dev)
    out["path"] = path
    print("path kept counts :", path.kept.tolist())
    print("path active nnz  :", path.active.tolist())

    # 6. comparing screening rules (the pluggable-rule registry, core/rules):
    #    - "feature_vi"  the paper's safe feature rule: shrinks the m-axis
    #    - "sample_vi"   margin-predicted + KKT-verified sample rule: shrinks the
    #                    n-axis (power grows as lambda shrinks and more samples
    #                    clear the margin)
    #    - "composite"   both at once: solver cost ~ kept_m x kept_n
    #    All produce the same path (screening is exact); they differ in how much
    #    of the problem the solver never has to touch.
    print(f"\nregistered rules: {available_rules()}")
    out["rules"] = {}
    for spec in ("feature_vi", "sample_vi", "composite", "dvi"):
        r = PathDriver(rules=spec, device=dev).run(ds.X, ds.y, n_lambdas=8,
                                                   lam_min_ratio=0.02)
        out["rules"][spec] = r
        print(f"{spec:10s} kept features {r.kept.tolist()}")
        print(f"{'':10s} kept samples  {r.kept_samples.tolist()} "
              f"(verify re-solves: {int(r.verify_rounds.sum())})")

    # 7. dynamic screening: the region certifying theta*(lambda) keeps shrinking
    #    while FISTA converges, so the solver re-screens itself every
    #    screen_every iterations — the feature mask tightens MID-solve, beyond
    #    what the between-lambda sequential screen could certify
    dyn = PathDriver(rules="feature_vi", dynamic=True, screen_every=25, device=dev).run(
        ds.X, ds.y, n_lambdas=8, lam_min_ratio=0.02)
    out["dynamic"] = dyn
    print("\ndynamic in-solver tightening (per-step kept trajectory):")
    for k, tele in sorted(dyn.extras["dynamic"].items()):
        if tele["kept_per_segment"] and tele["kept_per_segment"][-1] < dyn.kept[k]:
            print(f"  step {k}: initial screen kept {int(dyn.kept[k])} "
                  f"-> segments {tele['kept_per_segment']}")

    # 8. the on-device path engine: the SAME screened path with no host
    #    round trip between lambda steps (each chunk of FISTA iterations a
    #    captured CUDA graph on the card). Use it when solves are fast and
    #    orchestration dominates (engine="host" keeps the gather-mode FLOP
    #    reduction and verified sample rules). A batch of grids/problems runs
    #    as one program via core.svm_path_batched. The graphs are cached by
    #    X's address, so both calls take the one device copy of X.
    svm_path(X, y, n_lambdas=8, lam_min_ratio=0.1, engine="scan", device=dev)  # warm-up
    t0 = time.perf_counter()
    scan = svm_path(X, y, n_lambdas=8, lam_min_ratio=0.1, engine="scan", device=dev)
    t_scan = time.perf_counter() - t0
    out["scan"] = scan
    print(f"\nscan engine: {t_scan:.3f}s "
          f"(obj match host: "
          f"{float(abs(scan.objectives - path.objectives).max()):.2e})")

    # 9. compact reduction: the scan engine turns each step's certified keep
    #    mask into a physically gathered fixed-capacity active set INSIDE the
    #    program (cumsum compaction into a static bucket, mask fallback on
    #    overflow), so solver FLOPs track what screening keeps — the paper's
    #    compute reduction, realized with zero host sync. Rule of thumb:
    #      gather  (host)  multiplicative feature x sample cut, verified rules;
    #      mask    (scan)  weak screening, or batched paths;
    #      compact (scan)  screening certifies a small active set (small caps
    #                      below) — FLOP-proportional AND single-program.
    svm_path(X, y, n_lambdas=8, lam_min_ratio=0.1, engine="scan",
             reduce="compact", device=dev)  # warm-up (one solver body per bucket)
    t0 = time.perf_counter()
    comp = svm_path(X, y, n_lambdas=8, lam_min_ratio=0.1, engine="scan",
                    reduce="compact", device=dev)
    out["compact"] = comp
    print(f"compact scan: {time.perf_counter() - t0:.3f}s (mask {t_scan:.3f}s; "
          "the gap widens with screening power — see BENCH_screening.json)")
    print("  kept :", comp.kept.tolist())
    print("  caps :", comp.extras["caps"].tolist(),
          " (buffer the step actually solved in; m = mask fallback)")
    print("  resurrected per step:", comp.extras["resurrected"].tolist())

    # 10. out-of-core storage: when X does not fit on the device, hold it as
    #     host-resident feature chunks (dense or CSR; a CSR chunk is written
    #     densely on the device before its sweep). The bound sweep streams
    #     chunk by chunk (bitwise the in-core sweep on dense chunks) and the
    #     solver only ever sees the gathered rows that survive screening:
    #     peak device memory is O(chunk + kept), never O(m*n). Same API —
    #     pass the container where X would go.
    sp = make_sparse_classification(m=4000, n=300, k_active=12, density=0.05,
                                    seed=0)
    fc = FeatureChunked.from_csr(sp.csr, chunk_m=512)   # or .from_dense(sp.X, ...)
    oc = svm_path(fc, sp.y, n_lambdas=8, lam_min_ratio=0.1, device=dev)
    ref = svm_path(sp.X, sp.y, n_lambdas=8, lam_min_ratio=0.1, device=dev)
    out["out_of_core"], out["in_core"] = oc, ref
    print(f"\nout-of-core path (storage=csr, {fc.n_chunks} chunks): "
          f"obj match dense: "
          f"{float(abs(oc.objectives - ref.objectives).max()):.2e}")
    print("  max feature rows ever on device:",
          oc.extras["stream_stats"]["max_put_rows"], f"of m={fc.shape[0]}",
          f"(BCOO transfers: {oc.extras['stream_stats']['csr_puts']})")

    # 11. serving a mixed workload: many small path problems with ragged grids
    #     drain through the continuous-batching path server — jobs pad into
    #     power-of-two shape buckets, every resident job advances one lambda
    #     step per call of ONE step program (compact reduction shares a
    #     single capacity across the batch), and slots refill the moment a path
    #     certifies its last step. The warm program cache means a handful of
    #     captures serves ANY mix of grid lengths.
    mix = [PathJob(jid=i, X=d.X, y=d.y, n_lambdas=t, lam_min_ratio=0.2)
           for i, (d, t) in enumerate(
               (make_sparse_classification(m=200, n=90, k_active=8, seed=30 + i),
                t) for i, t in enumerate((4, 7, 5, 9)))]
    server = PathServer(slots=2, reduce="compact", device=dev)
    results = server.serve(mix, log=lambda *a, **k: None)
    seq = svm_path(mix[0].X, mix[0].y, lambdas=mix[0].lambdas, engine="scan",
                   reduce="compact", device=dev)
    out["server"], out["server_job0"], out["server_seq0"] = server, results[0], seq
    print("\npath server (4 ragged jobs, 2 slots):")
    print(f"  jobs/s {server.last_serve['jobs_per_s']:.2f}, "
          f"occupancy {server.last_serve['slot_occupancy']:.2f}, "
          f"programs {server.last_serve['programs']} "
          f"(hits {server.last_serve['hits']}, retraces "
          f"{server.last_serve['retraces']})")
    print("  grid lengths :", [len(j.lambdas) for j in mix])
    print(f"  job 0 vs sequential svm_path obj diff: "
          f"{float(abs(results[0].objectives - seq.objectives).max()):.2e}")
    return out


if __name__ == "__main__":
    main()
