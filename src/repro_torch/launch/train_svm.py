"""Sparse-SVM path trainer (the paper's workload) — PyTorch.

Port of the reference launcher: it builds a seeded synthetic problem (or
reads ``--libsvm FILE``), runs the screened regularization path on
``--device`` (default the GPU) and prints one line per lambda step: kept
features and samples, verification re-solves, active features, objective,
FISTA iterations and wall time. Its rows (the reference's keys) are
written to ``artifacts/svm_path.json`` under the working directory.

Engines. ``--engine host`` (default) is :class:`~repro_torch.core.path.PathDriver`
(``--reduce gather|mask``); ``--dynamic`` re-screens inside every solve each
``--screen-every`` iterations and adds each step's per-segment kept counts
to its line; ``--exact-lipschitz`` estimates L in every solve on its reduced
matrix. ``--engine scan`` runs the path with every solver decision on the
device (``core/path_scan.py``; feature rules, ``--reduce mask|compact``),
``--engine batched`` two problems at once (seeds ``--seed`` and ``--seed +
1``); their last line counts the host fetches and the CUDA graph replays.

Checkpoints. The host engine (in-core X) checkpoints the path after every
step into ``--ckpt-dir`` (default ``artifacts/svm_ckpt``, as the reference)
and a second run with the same directory resumes at the step after the
last one saved. ``--ckpt-dir`` other than the default with ``--engine
scan|batched`` or out-of-core storage is an error: those lanes have no
per-step state to resume.

Grid: ``--model M --data D`` with ``M * D > 1`` splits X's feature rows over
M and its sample columns over D and spawns ``M * D`` ranks
(``core/distributed.py`` ``run_grid``: ``torch.multiprocessing``, a
``file://`` store in a temporary directory; the parent saves X once and each
rank memory-maps its block). ``--engine scan`` runs
``path_scan.svm_path_scan_sharded`` (mask reduction; ``--reduce compact``
and ``--dynamic`` raise); ``--engine host`` runs ``PathDriver(grid=...,
reduce="mask")`` on every rank (any feature rule with a rule program, and
``auto`` with rank 0's policy; ``sample_vi``/``composite``/``sifs`` with
verified samples; ``--dynamic``; ``--exact-lipschitz``), checkpointing
through rank 0. ``--backend auto`` takes ``nccl`` when every rank has a GPU
of its own and ``gloo`` otherwise (ranks sharing one GPU, or ``--device
cpu``).

Data: ``--libsvm FILE`` reads a libsvm text file instead of the synthetic
problem. ``--storage chunked|csr|mmap`` runs the out-of-core lane
(``sparse.FeatureChunked``, host engine, gather): ``chunked`` streams dense
feature-row chunks of ``--chunk-m`` rows, ``csr`` CSR chunks (a synthetic
``--density < 1`` problem or ``--libsvm``), ``mmap`` a disk store built once
from ``--libsvm`` (in ``--store-dir``, default ``<FILE>.store``), or an
existing store opened from ``--store-dir`` alone. A store that is missing,
corrupt or unreadable (``StoreError``) ends the run with one log line and
exit code 2. Step lines then show the live chunks; ``--no-chunk-skip``
streams every chunk (the full-stream twin) and the last line the transfer
counts.

Serving: ``--serve`` drains ``--serve-jobs`` synthetic tenants' paths
(``launch/path_server.py`` ``demo_jobs`` at ``--m`` x ``--n``) through a
path server of ``--serve-slots`` slots (``--reduce mask|compact``, default
compact) and writes ``artifacts/svm_serve.json`` and
``artifacts/svm_serve_metrics.json``; ``--engine`` and ``--storage`` do not
apply.

Observability: ``--trace FILE`` records the ``repro_torch.obs`` spans of the
run (the grid's ranks' too) and writes them as Chrome trace-event JSON
(``REPRO_TRACE=1`` records without a file); ``--profile DIR`` captures a
``torch.profiler`` trace of the path in this process (one device; CUDA
activity on the card) inside a ``record_function("path")`` region, with
regions named as the host path's spans, into ``DIR/profile.json``.

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
    PYTHONPATH=src python -m repro_torch.launch.train_svm --ckpt-dir /tmp/ck \
        --device cpu   # run it twice: the second run resumes
    PYTHONPATH=src python -m repro_torch.launch.train_svm --trace /tmp/t.json \
        --profile /tmp/prof --device cpu
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
    PYTHONPATH=src python -m repro_torch.launch.train_svm --model 2 --data 2 \
        --rules composite --lam-min-ratio 0.02 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --model 2 --data 2 \
        --rules auto --exact-lipschitz --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --model 2 --data 2 \
        --engine scan --backend gloo --device cuda
    PYTHONPATH=src python -m repro_torch.launch.train_svm --serve --m 300 \
        --n 120 --serve-jobs 6 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..core import distributed as dist_mod
from ..core.path import PathDriver, svm_path
from ..core.path_scan import svm_path_scan_sharded
from ..data import load_libsvm, make_sparse_classification
from ..device import resolve_device
from ..obs import trace as obs_trace
from ..obs.log import get_logger
from ..obs.log import setup as log_setup
from ..sparse import FeatureChunked, StoreError
from .path_server import PathServer, demo_jobs, write_artifacts

_LOG = get_logger("launch.train_svm")
DEFAULT_CKPT_DIR = "artifacts/svm_ckpt"


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
                    help="estimate L in every solve on its reduced matrix instead "
                         "of once a path")
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
                    help="the --storage mmap store (default: <libsvm file>.store); "
                         "without --libsvm, an existing store is opened")
    ap.add_argument("--no-chunk-skip", dest="chunk_skip", action="store_false",
                    help="chunked storage: stream every chunk every step (the "
                         "full-stream twin of the chunk-skip screen)")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks over X's feature rows (a grid with --data)")
    ap.add_argument("--data", type=int, default=1,
                    help="ranks over X's sample columns")
    ap.add_argument("--backend", choices=("auto", "nccl", "gloo"), default="auto",
                    help="the grid's process-group backend: nccl needs a GPU per "
                         "rank; gloo runs ranks that share one GPU, or CPU ranks")
    ap.add_argument("--serve", action="store_true",
                    help="multi-tenant mode: drain --serve-jobs synthetic paths "
                         "through the path server (launch/path_server.py, "
                         "continuous batching of the batched scan step) "
                         "instead of solving one path")
    ap.add_argument("--serve-jobs", type=int, default=8)
    ap.add_argument("--serve-slots", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR, metavar="DIR",
                    help="host engine: checkpoint the path after every step here "
                         "and resume from the latest checkpoint there")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record the obs spans of the run and write them here as "
                         "Chrome trace-event JSON (open in Perfetto)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of this process "
                         "(CUDA activity on the card) into DIR/profile.json")
    ap.add_argument("--device", default="cuda")
    return ap


def _chunked_input(args, ap):
    """``(FeatureChunked, y)`` for ``--storage chunked|csr|mmap``."""
    if args.storage == "mmap":
        if args.libsvm is not None:
            return FeatureChunked.from_libsvm_cached(
                args.libsvm, store_dir=args.store_dir, chunk_m=args.chunk_m)
        if args.store_dir is None:
            ap.error("--storage mmap needs --libsvm FILE (to build the store) or "
                     "--store-dir DIR (to open an existing one)")
        # an existing store: a missing directory raises StoreMissingError,
        # checksum or size damage StoreCorruptError (exit 2 in main)
        fc = FeatureChunked.from_store(args.store_dir, chunk_m=args.chunk_m)
        fc.verify()
        if fc.labels is None:
            ap.error(f"store {args.store_dir} has no labels (y.bin); rebuild it from "
                     "the source text with --libsvm FILE")
        return fc, fc.labels
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


def _rows(res) -> list:
    """The reference launcher's result rows (``artifacts/svm_path.json``):
    the host lane's, the out-of-core lane's (``live_chunks``) or the scan
    engine's (``cap``, ``resurrected``)."""
    ex, rows = res.extras, []
    for k in range(len(res.lambdas)):
        row = {"lam": float(res.lambdas[k]), "kept": int(res.kept[k])}
        if "caps" in ex:
            row.update(nnz=int(res.active[k]), obj=float(res.objectives[k]),
                       iters=int(res.solver_iters[k]), cap=int(ex["caps"][k]),
                       resurrected=int(ex["resurrected"][k]))
            rows.append(row)
            continue
        row["kept_samples"] = int(res.kept_samples[k])
        if "live_chunks" in ex:
            row["live_chunks"] = int(ex["live_chunks"][k])
        row.update(nnz=int(res.active[k]), obj=float(res.objectives[k]),
                   iters=int(res.solver_iters[k]))
        if "live_chunks" not in ex:
            row["verify_rounds"] = int(res.verify_rounds[k])
        row["wall_s"] = float(res.wall_times[k])
        seg = ex.get("dynamic", {}).get(k)
        if "dynamic_keep_masks" in ex and seg is not None:
            row["dynamic_kept_per_segment"] = seg["kept_per_segment"]
            row["kept_final"] = int(ex["dynamic_keep_masks"][k].sum())
        rows.append(row)
    return rows


def _write_rows(results) -> None:
    out = Path("artifacts")
    out.mkdir(exist_ok=True)
    rows = [_rows(r) for r in results]
    (out / "svm_path.json").write_text(
        json.dumps(rows[0] if len(rows) == 1 else rows, indent=2))


def _host_driver(opts: dict, reduce, device, **kw) -> PathDriver:
    """The host lane's driver from the launcher's options (one device, or
    with ``grid=`` this rank's of a grid)."""
    return PathDriver(rules=[] if opts["rules"] == "none" else opts["rules"],
                      reduce=reduce, dynamic=opts["dynamic"],
                      screen_every=opts["screen_every"],
                      exact_lipschitz=opts["exact_lipschitz"],
                      ckpt_dir=opts["ckpt_dir"], device=device, **kw)


def _grid_rank(grid, arrays, lane: str, device: str, kw: dict):
    """One rank of the launcher's grid: its block of the memory-mapped X and
    its columns of y, then the lane (``"scan"``: the sharded scan engine, the
    reference launcher's ``run_path_scan`` on a mesh; ``"host"``:
    ``PathDriver(grid=grid, reduce="mask")``); returns its PathResult, its
    all-reduce counts and, with ``kw["trace"]``, its recorded spans."""
    dist_mod.ALLREDUCE.update(calls=0, bytes=0)
    kw = dict(kw)
    if kw.pop("trace", False):
        obs_trace.enable()
    X = torch.from_numpy(np.array(grid.block(arrays["X"])))
    y = torch.from_numpy(np.array(grid.col_block(arrays["y"])))
    grid_kw = {k: kw.pop(k) for k in ("n_lambdas", "lam_min_ratio")}
    t0 = time.perf_counter()
    if lane == "scan":
        res = svm_path_scan_sharded(grid, X, y, device=device, **grid_kw, **kw)
    else:
        res = _host_driver(kw, "mask", device, grid=grid).run(X, y, **grid_kw)
    stats = {"wall_s": time.perf_counter() - t0, **dist_mod.ALLREDUCE}
    return res, stats, obs_trace.get_tracer().events if obs_trace.enabled() else []


def pick_backend(backend: str, device: torch.device, ranks: int) -> str:
    """``nccl`` when every rank has a GPU of its own, else ``gloo``; an
    explicit choice is checked."""
    own_gpus = device.type == "cuda" and torch.cuda.device_count() >= ranks
    if backend == "auto":
        return "nccl" if own_gpus else "gloo"
    if backend == "nccl" and not own_gpus:
        raise ValueError(f"--backend nccl needs a GPU per rank ({ranks}); this "
                         "machine has fewer (use --backend gloo)")
    return backend


def run_grid_lane(X, y, lane: str, model: int, data: int, backend: str = "auto",
                  device="cuda", **kw):
    """Spawns the ``model x data`` ranks of a lane (``"scan"`` or
    ``"host"``) on ``(X, y)``; returns ``(rank 0's PathResult, per-rank
    stats)``. ``kw``: the lane's options (both lanes': ``n_lambdas``,
    ``lam_min_ratio``, ``rules``, ``exact_lipschitz`` and ``trace``, whose
    ranks' spans join this process's tracer with the rank as their thread
    id; the host lane's also ``dynamic``, ``screen_every``, ``ckpt_dir``). The parent
    builds the kernel library before the ranks start, so they load it and
    never build it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..kernels import build

        build.library()
    backend = pick_backend(backend, dev, model * data)
    outs = dist_mod.run_grid(_grid_rank, model, data,
                             {"X": np.asarray(X, np.float32),
                              "y": np.asarray(y, np.float32)},
                             (lane, dev.type, kw), backend=backend, device=dev.type)
    tracer = obs_trace.get_tracer()
    for rank, (_, _, events) in enumerate(outs):
        for ev in events:
            tracer._append(dict(ev, tid=rank))
    return outs[0][0], [o[1] for o in outs]


def _check_grid_args(args, ap, reduce) -> None:
    if args.model < 1 or args.data < 1:
        ap.error("--model and --data must be at least 1")
    if args.model * args.data == 1:
        return
    if args.storage != "dense":
        ap.error("--storage chunked|csr|mmap streams one chunk to one device; use "
                 "--storage dense on a grid")
    if args.engine == "batched":
        ap.error("--engine batched runs on one device; use --engine scan or host "
                 "on a grid")
    if args.engine == "scan" and reduce == "compact":
        ap.error("--reduce compact needs the single-device scan engine (compaction "
                 "indexes global feature rows); use --reduce mask on a grid")
    if args.engine == "scan" and args.dynamic:
        ap.error("--dynamic is not supported on the sharded scan engine; use "
                 "--engine host on a grid")
    if args.engine == "host" and args.reduce == "gather":
        ap.error("the host lane on a grid reduces by mask (--reduce mask)")


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    reduce = _check_serve_args(args, ap) if args.serve else _check_path_args(args, ap)
    device = resolve_device(args.device)  # before anything is written
    log_setup()
    if args.trace:
        obs_trace.enable()
    try:
        if args.serve:
            return _main_serve(args, reduce, device)
        if args.model * args.data > 1:
            return _main_grid(args, device)
        try:
            return _run(args, ap, reduce, device)
        except StoreError as e:
            # a missing store, a checksum mismatch or exhausted read retries:
            # one line and exit code 2, not a traceback
            _LOG.error("%s: %s", type(e).__name__, e)
            raise SystemExit(2)
    finally:
        if args.trace:
            _LOG.info("chrome trace written to %s (load in Perfetto)",
                      obs_trace.export_chrome(args.trace))


def _check_serve_args(args, ap) -> str:
    """``--serve``: the reduction of the server's steps (default compact);
    the options of one path's lanes do not apply."""
    if (args.engine != ap.get_default("engine") or args.storage != "dense"
            or args.model * args.data > 1):
        raise SystemExit("--serve runs the batched scan step through the path "
                         "server; --engine/--storage do not apply")
    return args.reduce or "compact"


def _main_serve(args, reduce, device) -> int:
    """``--serve``: ``--serve-jobs`` synthetic tenants (``demo_jobs`` at
    ``--m`` x ``--n``) drained through a ``--serve-slots`` path server; the
    summary and the metrics go to ``artifacts/``."""
    server = PathServer(slots=args.serve_slots, reduce=reduce, device=device)
    server.serve(demo_jobs(args.serve_jobs, m=args.m, n=args.n))
    write_artifacts(server)
    return 0


def _check_path_args(args, ap) -> str:
    """One path's lanes: the reduction (host: gather, scan engines: mask by
    default), with the combinations that do not run refused."""
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
    if (not host or chunked) and args.ckpt_dir != DEFAULT_CKPT_DIR:
        ap.error("--ckpt-dir has no effect here: the scan engines run the path "
                 "without per-step host state and the out-of-core lane does not "
                 "checkpoint; use --engine host with --storage dense")
    _check_grid_args(args, ap, reduce)
    if args.profile and args.model * args.data > 1:
        ap.error("--profile captures this process; the grid's ranks are others")
    return reduce


@contextlib.contextmanager
def _profiled(profile_dir, device):
    """With ``--profile DIR``: a ``torch.profiler`` capture (CUDA activity on
    the card) of the block, inside a ``record_function("path")`` region,
    written to ``DIR/profile.json``."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("path"):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "profile.json"))
    _LOG.info("profiler trace written to %s", out / "profile.json")


def _run(args, ap, reduce, device) -> int:
    """One device: the host, scan or batched engine, in core or out of core."""
    chunked = args.storage != "dense"
    seeds = range(args.seed, args.seed + (2 if args.engine == "batched" else 1))
    if chunked:
        Xs, ys = _chunked_input(args, ap)
    else:
        sets = ([load_libsvm(args.libsvm)] if args.libsvm is not None else
                [make_sparse_classification(m=args.m, n=args.n,
                                            density=args.density, seed=s)
                 for s in seeds])
        Xs, ys = sets[0].X, sets[0].y
        if args.engine == "batched":
            Xs, ys = np.stack([d.X for d in sets]), np.stack([d.y for d in sets])
    t0 = time.perf_counter()
    grid = dict(n_lambdas=args.n_lambdas, lam_min_ratio=args.lam_min_ratio)
    with _profiled(args.profile, device):
        if args.engine == "host":
            opts = dict(vars(args), ckpt_dir=None) if chunked else vars(args)
            driver = _host_driver(opts, reduce, device, chunk_skip=args.chunk_skip)
            results = [driver.run(Xs, ys, **grid)]
        else:
            results = svm_path(Xs, ys, rules=[] if args.rules == "none" else args.rules,
                               reduce=reduce, dynamic=args.dynamic,
                               screen_every=args.screen_every, engine=args.engine,
                               exact_lipschitz=args.exact_lipschitz, device=device,
                               **grid)
            if args.engine == "scan":
                results = [results]
    total = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    m, n = Xs.shape[-2:]
    ck = results[0].extras.get("checkpoint")
    if ck is not None and ck["resumed_at"] > 1:
        print(f"resumed at step {ck['resumed_at']} from {ck['dir']}")
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
    _write_rows(results)
    return 0


def _main_grid(args, device) -> int:
    """``--model M --data D`` with ``M * D > 1``: the lane on spawned ranks."""
    ds = (load_libsvm(args.libsvm) if args.libsvm is not None else
          make_sparse_classification(m=args.m, n=args.n, density=args.density,
                                     seed=args.seed))
    kw = dict(n_lambdas=args.n_lambdas, lam_min_ratio=args.lam_min_ratio,
              rules="none" if args.rules == "none" else args.rules,
              exact_lipschitz=args.exact_lipschitz, trace=bool(args.trace))
    if args.engine == "host":
        kw.update(dynamic=args.dynamic, screen_every=args.screen_every,
                  ckpt_dir=str(Path(args.ckpt_dir).resolve()))
    t0 = time.perf_counter()
    res, stats = run_grid_lane(ds.X, ds.y, args.engine, args.model, args.data,
                               args.backend, device, **kw)
    total = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    m, n = ds.X.shape
    ck = res.extras.get("checkpoint")
    if ck is not None and ck["resumed_at"] > 1:
        print(f"resumed at step {ck['resumed_at']} from {ck['dir']}")
    print(f"device={name} m={m} n={n} seed={args.seed} engine={args.engine} "
          f"grid={args.model}x{args.data} backend={res.extras['backend']} "
          f"rules={args.rules} dynamic={args.dynamic} "
          f"lam_max={res.extras['lam_max']:.6g}")
    _print_path(res)
    for r, st in enumerate(stats):
        print(f"rank {r} wall={st['wall_s']:.3f}s allreduce_calls={st['calls']} "
              f"allreduce_bytes={st['bytes']}")
    print(f"path wall {total:.3f}s")
    _write_rows([res])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
