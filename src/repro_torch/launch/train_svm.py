"""Single-device sparse-SVM path trainer (the paper's workload) — PyTorch.

Port of the reference launcher's host lane: it builds a seeded synthetic
problem, runs the screened regularization path (``core/path.py``
``svm_path``) on ``--device`` (default the GPU) and prints one line per
lambda step: kept features and samples, verification re-solves, active
features, objective, FISTA iterations and wall time. ``--dynamic`` re-screens
inside every solve each ``--screen-every`` iterations and adds each step's
per-segment kept counts to its line. ``--engine scan`` runs the path with
every solver decision on the device (``core/path_scan.py``; feature rules,
``--reduce mask|compact``, ``--exact-lipschitz``), ``--engine batched``
two problems at once (seeds ``--seed`` and ``--seed + 1``); their last line
counts the host fetches and the CUDA graph replays. No mesh, checkpoint or serve
mode.

    PYTHONPATH=src python -m repro_torch.launch.train_svm --device cuda
    PYTHONPATH=src python -m repro_torch.launch.train_svm --m 2000 --n 400 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --rules composite \
        --reduce mask --lam-min-ratio 0.02 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --dynamic \
        --screen-every 25 --rules composite --reduce mask --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --rules dvi --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --rules edpp --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --rules sifs \
        --lam-min-ratio 0.02 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --engine scan \
        --reduce compact --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --engine batched \
        --reduce compact --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.path import svm_path
from ..data import make_sparse_classification
from ..device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=2000, help="features")
    ap.add_argument("--n", type=int, default=400, help="samples")
    ap.add_argument("--density", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-lambdas", type=int, default=8)
    ap.add_argument("--lam-min-ratio", type=float, default=0.1)
    ap.add_argument("--rules",
                    choices=("feature_vi", "dvi", "edpp", "auto", "sample_vi",
                             "composite", "sifs", "none"),
                    default="feature_vi")
    ap.add_argument("--engine", choices=("host", "scan", "batched"), default="host")
    ap.add_argument("--reduce", choices=("gather", "mask", "compact"), default=None,
                    help="host: gather (default) or mask; scan and batched: "
                         "mask (default) or compact")
    ap.add_argument("--exact-lipschitz", action="store_true",
                    help="scan engines: re-estimate L on each step's reduced matrix")
    ap.add_argument("--dynamic", action="store_true",
                    help="re-screen inside every FISTA solve each "
                         "--screen-every iterations (gap-certified)")
    ap.add_argument("--screen-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    return ap


def _print_path(res) -> None:
    dyn = res.extras.get("dynamic", {})
    for k in range(len(res.lambdas)):
        segs = ""
        if k in dyn:
            segs = f" kept_per_segment={dyn[k]['kept_per_segment']}"
        if "caps" in res.extras:
            segs += f" cap={res.extras['caps'][k]}"
        print(f"step {k:2d} lam={res.lambdas[k]:.6g} kept={res.kept[k]} "
              f"kept_samples={res.kept_samples[k]} "
              f"verify_rounds={res.verify_rounds[k]} "
              f"active={res.active[k]} obj={res.objectives[k]:.8g} "
              f"iters={res.solver_iters[k]} wall={res.wall_times[k]:.4f}s{segs}")


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    host = args.engine == "host"
    reduce = args.reduce or ("gather" if host else "mask")
    if reduce == ("compact" if host else "gather"):
        ap.error(f"--reduce {reduce} does not run on --engine {args.engine}: the "
                 "host engine takes gather or mask, the scan engines mask or compact")
    device = resolve_device(args.device)
    kw = dict(n_lambdas=args.n_lambdas, lam_min_ratio=args.lam_min_ratio,
              rules=[] if args.rules == "none" else args.rules, reduce=reduce,
              dynamic=args.dynamic, screen_every=args.screen_every,
              engine=args.engine, exact_lipschitz=args.exact_lipschitz,
              device=device)
    seeds = range(args.seed, args.seed + (2 if args.engine == "batched" else 1))
    sets = [make_sparse_classification(m=args.m, n=args.n, density=args.density, seed=s)
            for s in seeds]
    t0 = time.perf_counter()
    if args.engine == "batched":
        results = svm_path(np.stack([d.X for d in sets]), np.stack([d.y for d in sets]), **kw)
    else:
        results = [svm_path(sets[0].X, sets[0].y, **kw)]
    total = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    for seed, res in zip(seeds, results):
        print(f"device={name} m={args.m} n={args.n} seed={seed} engine={args.engine} "
              f"rules={args.rules} reduce={reduce} dynamic={args.dynamic} "
              f"lam_max={res.extras['lam_max']:.6g}")
        _print_path(res)
    fetches = results[0].extras.get("host_fetches")
    tail = ""
    if fetches is not None:
        tail = (f" host_fetches={sum(fetches.values())} {fetches} "
                f"graph_replays={results[0].extras['graphs']['replays']}")
    print(f"path wall {total:.3f}s{tail}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
