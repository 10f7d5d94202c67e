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

Data: ``--libsvm FILE`` reads a libsvm text file instead of the synthetic
problem. ``--storage chunked|csr|mmap`` runs the out-of-core lane
(``sparse.FeatureChunked``, host engine, gather): ``chunked`` streams dense
feature-row chunks of ``--chunk-m`` rows, ``csr`` CSR chunks (a synthetic
``--density < 1`` problem or ``--libsvm``), ``mmap`` a disk store built once
from ``--libsvm`` (in ``--store-dir``, default ``<FILE>.store``). Step lines
then show the live chunks; ``--no-chunk-skip`` streams every chunk (the
full-stream twin) and the last line the transfer counts.

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
    PYTHONPATH=src python -m repro_torch.launch.train_svm --storage chunked \
        --chunk-m 256 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --storage csr \
        --density 0.04 --chunk-m 256 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --libsvm data.svm \
        --storage mmap --store-dir /path/to/store --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.path import svm_path
from ..data import load_libsvm, make_sparse_classification
from ..device import resolve_device
from ..sparse import FeatureChunked


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
    ap.add_argument("--libsvm", default=None, metavar="FILE",
                    help="read a libsvm/svmlight text file (plain or gzip) "
                         "instead of generating synthetic data")
    ap.add_argument("--storage", choices=("dense", "chunked", "csr", "mmap"),
                    default="dense",
                    help="dense: in-core X on the device; chunked: host "
                         "feature-row chunks streamed to the device; csr: "
                         "CSR chunks, low-density ones swept as sparse "
                         "products; mmap: a disk store built once from "
                         "--libsvm (host engine, gather)")
    ap.add_argument("--chunk-m", type=int, default=512,
                    help="feature rows per chunk (--storage chunked|csr|mmap)")
    ap.add_argument("--store-dir", default=None, metavar="DIR",
                    help="the --storage mmap store (default: <libsvm file>.store)")
    ap.add_argument("--no-chunk-skip", dest="chunk_skip", action="store_false",
                    help="chunked storage: stream every chunk every step (the "
                         "full-stream twin of the chunk-skip screen)")
    ap.add_argument("--device", default="cuda")
    return ap


def _chunked_input(args, ap):
    """``(FeatureChunked, y)`` for ``--storage chunked|csr|mmap``."""
    if args.storage == "mmap":
        if args.libsvm is None:
            ap.error("--storage mmap needs --libsvm FILE (the store is built "
                     "from it once)")
        return FeatureChunked.from_libsvm_cached(
            args.libsvm, store_dir=args.store_dir, chunk_m=args.chunk_m)
    ds = (load_libsvm(args.libsvm) if args.libsvm is not None else
          make_sparse_classification(m=args.m, n=args.n, density=args.density,
                                     seed=args.seed))
    if args.storage == "csr":
        if ds.csr is None:
            ap.error("--storage csr needs a CSR dataset: --density < 1 or --libsvm")
        return FeatureChunked.from_csr(ds.csr, chunk_m=args.chunk_m), ds.y
    return FeatureChunked.from_dense(ds.X, chunk_m=args.chunk_m), ds.y


def _print_path(res) -> None:
    dyn = res.extras.get("dynamic", {})
    for k in range(len(res.lambdas)):
        segs = ""
        if k in dyn and "kept_per_segment" in dyn[k]:
            segs = f" kept_per_segment={dyn[k]['kept_per_segment']}"
        elif k in dyn:  # the streamed solver's report
            segs = f" dynamic={dyn[k]}"
        if "caps" in res.extras:
            segs += f" cap={res.extras['caps'][k]}"
        if "live_chunks" in res.extras:
            segs += (f" live_chunks={res.extras['live_chunks'][k]}"
                     f"/{res.extras['n_chunks']}")
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
    chunked = args.storage != "dense"
    if chunked and (args.engine != "host" or reduce != "gather"):
        ap.error("--storage chunked|csr|mmap runs on --engine host with "
                 "--reduce gather")
    if args.libsvm is not None and args.engine == "batched":
        ap.error("--engine batched generates its two problems; --libsvm reads one")
    device = resolve_device(args.device)
    kw = dict(n_lambdas=args.n_lambdas, lam_min_ratio=args.lam_min_ratio,
              rules=[] if args.rules == "none" else args.rules, reduce=reduce,
              dynamic=args.dynamic, screen_every=args.screen_every,
              engine=args.engine, exact_lipschitz=args.exact_lipschitz,
              device=device)
    seeds = range(args.seed, args.seed + (2 if args.engine == "batched" else 1))
    if chunked:
        Xs, ys = _chunked_input(args, ap)
        kw["chunk_skip"] = args.chunk_skip
    else:
        sets = ([load_libsvm(args.libsvm)] if args.libsvm is not None else
                [make_sparse_classification(m=args.m, n=args.n,
                                            density=args.density, seed=s)
                 for s in seeds])
        Xs, ys = sets[0].X, sets[0].y
        if args.engine == "batched":
            Xs, ys = np.stack([d.X for d in sets]), np.stack([d.y for d in sets])
    t0 = time.perf_counter()
    results = svm_path(Xs, ys, **kw)
    if args.engine != "batched":
        results = [results]
    total = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    m, n = Xs.shape[-2:]
    for seed, res in zip(seeds, results):
        print(f"device={name} m={m} n={n} seed={seed} engine={args.engine} "
              f"rules={args.rules} reduce={reduce} dynamic={args.dynamic} "
              f"storage={args.storage} lam_max={res.extras['lam_max']:.6g}")
        _print_path(res)
    fetches = results[0].extras.get("host_fetches")
    tail = ""
    if fetches is not None:
        tail = (f" host_fetches={sum(fetches.values())} {fetches} "
                f"graph_replays={results[0].extras['graphs']['replays']}")
    if chunked:
        st = results[0].extras["stream_stats"]
        tail += (f" chunks={results[0].extras['n_chunks']} chunk_m={args.chunk_m} "
                 f"chunk_skip={args.chunk_skip} max_put_rows={st['max_put_rows']} "
                 f"puts={st['puts']} csr_puts={st['csr_puts']} "
                 f"streamed={st['chunks_streamed']} skipped={st['chunks_skipped']} "
                 f"bytes_put={st['bytes_put']}")
    print(f"path wall {total:.3f}s{tail}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
