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
counts the host fetches and the CUDA graph replays. No checkpoint or serve
mode.

Grid: ``--model M --data D`` with ``M * D > 1`` splits X's feature rows over
M and its sample columns over D and spawns ``M * D`` ranks
(``core/distributed.py`` ``run_grid``: ``torch.multiprocessing``, a
``file://`` store in a temporary directory; the parent saves X once and each
rank memory-maps its block). ``--engine scan`` runs
``path_scan.svm_path_scan_sharded`` (mask reduction; ``--reduce compact``
and ``--dynamic`` raise); ``--engine host`` runs :func:`run_path`, the
reference launcher's sharded host loop (``screen_sharded``,
``sample_surplus_sharded`` with the rule's secant history,
``fista_sharded`` with L estimated once, verified samples). ``--backend
auto`` takes ``nccl`` when every rank has a GPU of its own and ``gloo``
otherwise (ranks sharing one GPU, or ``--device cpu``). The reference's host
lane also writes checkpoints (``--ckpt-dir``); this one does not yet.

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
    PYTHONPATH=src python -m repro_torch.launch.train_svm --model 2 --data 2 \
        --rules composite --lam-min-ratio 0.02 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train_svm --model 2 --data 2 \
        --engine scan --backend gloo --device cuda
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import distributed as dist_mod
from ..core.dual import (
    bias_at_lambda_max_sharded,
    lambda_max_sharded,
    theta_at_lambda_max_sharded,
)
from ..core.path import PathResult, _validate_grid, default_lambda_grid, svm_path
from ..core.path_scan import svm_path_scan_sharded
from ..core.rules import AutoRule, FeatureVIRule, SampleVIRule, make_rules
from ..core.rules.base import (
    AXIS_FEATURES,
    AXIS_SAMPLES,
    ConvexRegion,
    dynamic_tau,
    solve_with_verification,
)
from ..core.solver import HEALTH_SCREEN_REFUSED, gap_theta_delta, lipschitz_estimate
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
    ap.add_argument("--model", type=int, default=1,
                    help="ranks over X's feature rows (a grid with --data)")
    ap.add_argument("--data", type=int, default=1,
                    help="ranks over X's sample columns")
    ap.add_argument("--backend", choices=("auto", "nccl", "gloo"), default="auto",
                    help="the grid's process-group backend: nccl needs a GPU per "
                         "rank; gloo runs ranks that share one GPU, or CPU ranks")
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


def run_path(grid, X, y, lambdas=None, n_lambdas: int = 10,
             lam_min_ratio: float = 0.1, *, tol: float = 1e-9, max_iters: int = 4000,
             rules="feature_vi", shrink_factor: float = 1.5,
             max_verify_rounds: int = 3, dynamic: bool = False,
             screen_every: int = 50, L=None, device="cuda") -> PathResult:
    """The host lane on a grid (the reference launcher's ``run_path``, its
    checkpoints left out): every rank calls it with its block ``X`` and its
    columns ``y`` and gets the same :class:`PathResult`.

    Each step screens from the previous step's certified anchor:
    ``FeatureVIRule`` through ``distributed.screen_sharded``, ``edpp`` and
    ``dvi`` through their own ``bounds``/``keep`` on the rank's rows (on a
    grid with ``data == 1`` only, where the region's scalars are global;
    ``auto`` raises: its policy reads each rank's clock),
    ``SampleVIRule`` through ``distributed.sample_surplus_sharded`` with its
    secant history on the rule object; then the mask-mode solve
    (``distributed.fista_sharded`` with the path's L, estimated once, and
    ``--dynamic``'s in-solver re-screen) inside ``solve_with_verification``,
    whose float64 check of the screened samples runs sharded
    (``distributed.sample_violators_sharded``); then the certificate of the
    next anchor (``solver.gap_theta_delta``, 8 feasibility rounds, sharded)
    and the trust radii ``shrink_factor * ||w - w_prev||`` and ``|b -
    b_prev|``. ``L``: a known Lipschitz bound (else the sharded estimate).
    The steps are those of ``svm_path(reduce="mask")``."""
    dev = resolve_device(device)
    col = grid.col
    X = torch.as_tensor(X).to(dev).contiguous()
    y = torch.as_tensor(y).to(device=dev, dtype=X.dtype)
    m_loc, n_loc = X.shape
    m, n = grid.shape(X)
    c0 = grid.j * n_loc
    rule_list = make_rules(None if rules in (None, "none") else rules)
    feature_rules = [r for r in rule_list if r.axis == AXIS_FEATURES]
    sample_rules = [r for r in rule_list if r.axis == AXIS_SAMPLES]
    generic = [r for r in feature_rules if type(r) is not FeatureVIRule]
    if any(isinstance(r, AutoRule) for r in generic):
        raise ValueError("rules='auto' picks its bound stack from each rank's own "
                         "clock, so the ranks would screen under different "
                         "policies; on a grid use feature_vi, edpp or dvi")
    if grid.data > 1 and generic:
        raise ValueError(f"feature rules {[r.name for r in generic]} have no sharded "
                         "route over samples; on a grid with --data > 1 use "
                         "feature_vi, sample_vi or composite")
    if any(type(r) is not SampleVIRule for r in sample_rules):
        raise ValueError("on a grid the sample rule is sample_vi "
                         "(sample_surplus_sharded)")
    for rule in rule_list:
        rule.prepare(X, y)
    L_path = lipschitz_estimate(X, col=col, cols=(c0, n)) if L is None else L
    lam_max_val = float(lambda_max_sharded(X, y, col, n))
    if lambdas is None:
        lambdas = default_lambda_grid(lam_max_val, n_lambdas, lam_min_ratio)
    lambdas = _validate_grid(lambdas)
    T = len(lambdas)
    f64 = dict(dtype=np.float64)
    weights = torch.zeros((T, m_loc), dtype=torch.float64, device=dev)
    biases, objectives, wall, s_times = (np.zeros((T,), **f64) for _ in range(4))
    kept, kept_s, vrounds, active, iters, health = (
        np.zeros((T,), dtype=np.int64) for _ in range(6))
    dyn_log, sample_masks = {}, {}
    # the features fed to each step's solver; with dynamic, those still live
    # at its end (the rank's rows, gathered at the end)
    masks = torch.ones((2 if dynamic else 1, T, m_loc), dtype=torch.int32, device=dev)
    # step 0 at lam_max: the closed form is exact (delta = 0)
    w = torch.zeros((m_loc,), dtype=X.dtype, device=dev)
    b = float(bias_at_lambda_max_sharded(y, col, n))
    theta = theta_at_lambda_max_sharded(y, float(lambdas[0]), col, n)
    delta = torch.zeros((), dtype=X.dtype, device=dev)
    xi0 = torch.clamp_min(1.0 - y.double() * b, 0.0)
    biases[0] = b
    objectives[0] = 0.5 * float(col.psum_data(torch.sum(xi0 * xi0)))
    dw = db = float("inf")
    lam_prev = float(lambdas[0])
    tau_dyn = dynamic_tau(feature_rules)
    violators = dist_mod.sample_violators_sharded(
        grid, X, y, [r for r in sample_rules if r.needs_verification])
    for k in range(1, T):
        lam = float(lambdas[k])
        t0 = time.perf_counter()
        keep = torch.ones((m_loc,), dtype=torch.bool, device=dev)
        s_mask = np.ones((n,), dtype=bool)
        if rule_list and not bool(torch.isfinite(delta)):
            health[k] |= HEALTH_SCREEN_REFUSED  # no region: keep everything
        elif rule_list:
            region = None
            for rule in feature_rules:
                if type(rule) is FeatureVIRule:
                    keep &= dist_mod.screen_sharded(grid, X, y, lam_prev, lam, theta,
                                                    tau=rule.tau, delta=delta)[0]
                    continue
                region = region or ConvexRegion.build(
                    y, lam_prev, lam, theta, delta=delta, w1=w, b1=b, dw=dw, db=db)
                keep &= rule.keep(rule.bounds(X, y, region))
            for rule in sample_rules:
                surplus, u1 = dist_mod.sample_surplus_sharded(
                    grid, X, y, w, b, dw, db, rule._u_prev, rule.shrink_factor,
                    rule.margin_floor)
                rule._u_prev = u1
                s_keep = dist_mod.gather_cols(grid, rule.keep(surplus).to(torch.float32))
                s_mask &= s_keep.cpu().numpy() > 0.5
        s_times[k] = time.perf_counter() - t0
        fm = keep.to(X.dtype)
        masks[:, k] = keep.to(torch.int32)
        kept[k] = int(col.psum_model(torch.sum(fm)))
        warm = {"w": w, "b": b}

        def solve(mask):
            sm = (None if mask.all() else
                  torch.from_numpy(mask[c0:c0 + n_loc]).to(device=dev, dtype=X.dtype))
            r = dist_mod.fista_sharded(
                grid, X, y, lam, max_iters=max_iters, tol=tol, w0=warm["w"] * fm,
                b0=warm["b"], sample_mask=sm, feature_mask=fm,
                screen_every=screen_every if dynamic else None, tau=tau_dyn, L=L_path)
            warm["w"], warm["b"] = r.w, float(r.b)
            return r, r.w, float(r.b)

        res, w_new, b_new, rounds = solve_with_verification(
            solve, sample_rules, X, y, s_mask, max_rounds=max_verify_rounds,
            violators=violators)
        theta, delta, _ = gap_theta_delta(X, y, w_new, torch.as_tensor(
            b_new, dtype=X.dtype, device=dev), lam, None, n_feas_iters=8, u=None,
            col=col)
        step = w_new.double() - w.double()
        dw = shrink_factor * float(torch.sqrt(col.psum_model(torch.sum(step * step))))
        db = shrink_factor * abs(b_new - b)
        w, b, lam_prev = w_new, b_new, lam
        weights[k], biases[k], objectives[k] = w.double(), b, res.obj
        kept_s[k], vrounds[k], iters[k] = int(s_mask.sum()), rounds, res.n_iters
        if sample_rules:
            sample_masks[k] = s_mask.copy()
        active[k] = int(col.psum_model(torch.sum(torch.abs(w) > 1e-10).to(torch.int32)))
        health[k] |= res.health
        if dynamic:
            dyn_log[k] = {"kept_per_segment": [int(v) for v in res.kept_per_segment]}
            masks[1, k] = res.feature_mask.to(torch.int32)
        wall[k] = time.perf_counter() - t0
    masks = dist_mod.gather_rows(grid, masks).cpu().numpy() > 0
    extras = {"lam_max": lam_max_val, "health": health, "engine": "host_sharded",
              "keep_masks": masks[0], "sample_masks": sample_masks,
              "grid": {"model": grid.model, "data": grid.data},
              "backend": grid.backend}
    if dynamic:
        extras.update(dynamic=dyn_log, dynamic_keep_masks=masks[1])
    return PathResult(
        lambdas=lambdas, weights=dist_mod.gather_rows(grid, weights).cpu().numpy(),
        biases=biases, objectives=objectives, kept=kept, active=active,
        solver_iters=iters, wall_times=wall, screen_times=s_times,
        screened=bool(rule_list), kept_samples=kept_s, verify_rounds=vrounds,
        rules=tuple(r.name for r in rule_list), extras=extras)


def _grid_rank(grid, arrays, lane: str, device: str, kw: dict):
    """One rank of the launcher's grid: its block of the memory-mapped X and
    its columns of y, then the lane (``"scan"``: the sharded scan engine, the
    reference launcher's ``run_path_scan`` on a mesh; ``"host"``:
    :func:`run_path`); returns its PathResult and its all-reduce counts."""
    dist_mod.ALLREDUCE.update(calls=0, bytes=0)
    X = torch.from_numpy(np.array(grid.block(arrays["X"])))
    y = torch.from_numpy(np.array(grid.col_block(arrays["y"])))
    fn = svm_path_scan_sharded if lane == "scan" else run_path
    t0 = time.perf_counter()
    res = fn(grid, X, y, device=device, **kw)
    return res, {"wall_s": time.perf_counter() - t0, **dist_mod.ALLREDUCE}


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
    stats)``. The parent builds the kernel library before the ranks start,
    so they load it and never build it."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..kernels import build

        build.library()
    backend = pick_backend(backend, dev, model * data)
    outs = dist_mod.run_grid(_grid_rank, model, data,
                             {"X": np.asarray(X, np.float32),
                              "y": np.asarray(y, np.float32)},
                             (lane, dev.type, kw), backend=backend, device=dev.type)
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
    if args.exact_lipschitz:
        ap.error("--exact-lipschitz is a single-device option")


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
    _check_grid_args(args, ap, reduce)
    device = resolve_device(args.device)
    if args.model * args.data > 1:
        return _main_grid(args, device)
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


def _main_grid(args, device) -> int:
    """``--model M --data D`` with ``M * D > 1``: the lane on spawned ranks."""
    ds = (load_libsvm(args.libsvm) if args.libsvm is not None else
          make_sparse_classification(m=args.m, n=args.n, density=args.density,
                                     seed=args.seed))
    kw = dict(n_lambdas=args.n_lambdas, lam_min_ratio=args.lam_min_ratio,
              rules="none" if args.rules == "none" else args.rules)
    if args.engine == "host":
        kw.update(dynamic=args.dynamic, screen_every=args.screen_every)
    t0 = time.perf_counter()
    res, stats = run_grid_lane(ds.X, ds.y, args.engine, args.model, args.data,
                               args.backend, device, **kw)
    total = time.perf_counter() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    m, n = ds.X.shape
    print(f"device={name} m={m} n={n} seed={args.seed} engine={args.engine} "
          f"grid={args.model}x{args.data} backend={res.extras['backend']} "
          f"rules={args.rules} dynamic={args.dynamic} "
          f"lam_max={res.extras['lam_max']:.6g}")
    _print_path(res)
    for r, st in enumerate(stats):
        print(f"rank {r} wall={st['wall_s']:.3f}s allreduce_calls={st['calls']} "
              f"allreduce_bytes={st['bytes']}")
    print(f"path wall {total:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
