"""Rank programs of ``tests/test_torch_distributed.py``: module-level
functions (spawned ranks unpickle them by name) that import no JAX.

Each program takes the rank's grid and the memory-mapped whole arrays, runs
the sharded functions on its blocks and returns whole vectors (gathered
over the grid) as numpy, so the test can hold every rank's answer against
the single-device one.
"""

import numpy as np
import torch

from repro_torch.core import distributed as D
from repro_torch.core.dual import lambda_max_sharded, theta_at_lambda_max_sharded
from repro_torch.core.path import PathDriver
from repro_torch.core.path_scan import svm_path_scan_sharded
from repro_torch.core.rules import AutoRule
from repro_torch.core.solver import lipschitz_estimate


def _np(t):
    return t.detach().cpu().numpy()


def suite(grid, arrays, cfg):
    """Every sharded function of the slice on one grid (see the test
    module's fixtures for ``cfg``)."""
    torch.set_num_threads(1)
    X = torch.from_numpy(np.array(grid.block(arrays["X"])))
    y = torch.from_numpy(np.array(grid.col_block(arrays["y"])))
    m, n = grid.shape(X)
    col = grid.col
    rows = lambda v: torch.from_numpy(np.array(grid.row_block(v)))  # noqa: E731
    cols = lambda v: torch.from_numpy(np.array(grid.col_block(v)))  # noqa: E731
    out = {}
    lmax = lambda_max_sharded(X, y, col, n)
    out["lam_max"] = float(lmax)
    theta0 = theta_at_lambda_max_sharded(y, lmax, col, n)
    out["L"] = float(lipschitz_estimate(X, col=col, cols=(grid.j * X.shape[1], n)))
    keep, bounds = D.screen_sharded(grid, X, y, lmax, 0.4 * lmax, theta0, delta=0.0)
    out["bounds0"] = _np(D.gather_rows(grid, bounds))
    out["keep0"] = _np(D.gather_rows(grid, keep.to(torch.int32))) > 0
    keep, bounds = D.screen_sharded(grid, X, y, cfg["lam1"], cfg["lam2b"],
                                    cols(cfg["theta_s"]), delta=cfg["delta_s"])
    out["bounds_s"] = _np(D.gather_rows(grid, bounds))
    out["keep_s"] = _np(D.gather_rows(grid, keep.to(torch.int32))) > 0
    surplus, u1 = D.sample_surplus_sharded(
        grid, X, y, rows(cfg["w1"]), cfg["b1"], cfg["dw"], cfg["db"],
        cols(cfg["u_prev"]), 2.0, 1e-3)
    out["surplus"] = _np(D.gather_cols(grid, surplus))
    out["u1"] = _np(D.gather_cols(grid, u1))
    fix = dict(max_iters=cfg["iters"], tol=-1.0, L=cfg["L"])
    r = D.fista_sharded(grid, X, y, cfg["lam2"], **fix)
    out["static"] = (_np(D.gather_rows(grid, r.w)), float(r.b), r.obj, r.n_iters)
    r = D.fista_sharded(grid, X, y, cfg["lam2"], sample_mask=cols(cfg["sm"]),
                        feature_mask=rows(cfg["fm"]), **fix)
    out["masked"] = (_np(D.gather_rows(grid, r.w)), float(r.b), r.obj, r.n_iters)
    r = D.fista_sharded(grid, X, y, cfg["lam2"], screen_every=cfg["screen_every"],
                        **fix)
    out["dynamic"] = (_np(D.gather_rows(grid, r.w)), float(r.b), r.obj, r.n_iters,
                      _np(D.gather_rows(grid, r.feature_mask.to(torch.int32))) > 0,
                      r.kept_per_segment)
    out["paths"] = {}
    for rules in cfg["rules"]:
        p = svm_path_scan_sharded(grid, X, y, rules=rules, L=cfg["L"], device="cpu",
                                  **cfg["path"])
        out["paths"][rules] = (p.objectives, p.weights, p.kept, p.extras["keep_masks"],
                               p.extras["engine"], p.extras["grid"])
    out["host_lanes"] = {}
    for name, kw in cfg.get("host_lanes", {}).items():
        p, decisions = host_lane(grid, X, y, cfg["L"], kw)
        out["host_lanes"][name] = (p.objectives, p.kept, p.kept_samples, p.weights,
                                   p.biases, p.extras["keep_masks"],
                                   p.extras.get("dynamic"),
                                   p.extras.get("dynamic_keep_masks"), decisions)
    out["allreduce"] = dict(D.ALLREDUCE)
    return out


def host_lane(grid, X, y, L, kw, device="cpu", **driver_kw):
    """The launcher's host lane on this rank: ``PathDriver(grid=grid,
    reduce="mask")`` with ``kw`` (rules, solver options, the lambda grid;
    ``exact_lipschitz`` drops the path's L). Returns the result and, for
    ``auto``, the policy's decisions per step (extra sweep run, extra sweep
    on next, extra features screened)."""
    kw = dict(kw)
    grid_kw = {k: kw.pop(k) for k in ("n_lambdas", "lam_min_ratio")}
    if kw["rules"] == "auto":
        kw["rules"] = AutoRule()
    if not kw.get("exact_lipschitz"):
        kw["L"] = L
    drv = PathDriver(grid=grid, reduce="mask", device=device, **kw, **driver_kw)
    res = drv.run(X, y, **grid_kw)
    decisions = None
    if isinstance(kw["rules"], AutoRule):
        decisions = [(t["extra_swept"], t["use_extra"], t["extra_screened"])
                     for t in kw["rules"].telemetry]
    return res, decisions


class Interrupted(RuntimeError):
    """Raised by :func:`interrupted_path`'s injector."""


def interrupted_path(grid, arrays, cfg):
    """A host-lane path on this rank with a checkpoint directory, stopped by
    an exception injected at step ``cfg["stop"]`` (after its solve, before
    its certificate and checkpoint): rank 0 has saved every step before it.
    Returns the step that stopped it."""
    torch.set_num_threads(1)
    X = torch.from_numpy(np.array(grid.block(arrays["X"])))
    y = torch.from_numpy(np.array(grid.col_block(arrays["y"])))
    drv = PathDriver(cfg["rules"], grid=grid, reduce="mask", L=cfg["L"],
                     ckpt_dir=cfg["dir"], device="cpu", max_iters=cfg["max_iters"],
                     tol=-1.0)

    def stop(k, w, b):
        if k == cfg["stop"]:
            raise Interrupted(f"step {k}")
        return w, b

    drv._fault_injector = stop
    try:
        drv.run(X, y, n_lambdas=cfg["n_lambdas"], lam_min_ratio=cfg["lam_min_ratio"])
    except Interrupted:
        return cfg["stop"]
    return None


def compressed_psum_rank(grid, arrays, cfg):
    """``optim.compressed_psum`` over the whole world, ``cfg["rounds"]``
    times with error feedback: this rank's row of ``arrays["x"]``, its own
    generator (``cfg["seed"] + rank``). Returns each round's mean and error
    and the rank's first-round quantization (``x - error``)."""
    import torch.distributed as dist

    from repro_torch.optim import compressed_psum

    torch.set_num_threads(1)
    rank = dist.get_rank()
    x = torch.from_numpy(np.array(arrays["x"][rank]))
    gen = torch.Generator().manual_seed(cfg["seed"] + rank)
    means, errors, err = [], [], None
    for _ in range(cfg["rounds"]):
        mean, err = compressed_psum(x, None, gen, err)
        means.append(_np(mean))
        errors.append(_np(err))
    return {"rank": rank, "means": np.stack(means), "errors": np.stack(errors)}
